from uresnet_pytorch_tpu_torch.utils.csvdata import CSVData  # noqa: F401
from uresnet_pytorch_tpu_torch.utils.timing import StopWatch, span  # noqa: F401
