#!/usr/bin/env python
"""CLI entry point of the PyTorch/CUDA port, beside the reference's
bin/uresnet.py, with the same subcommands, flags, files and CSV columns:

    bin/uresnet_torch.py train -io h5 -if events.h5 -bs 2 -it 100 ...
    bin/uresnet_torch.py inference -mp 'weights/snapshot-*.ckpt' -of out.h5 ...
    bin/uresnet_torch.py iotest -io h5 -if events.h5 ...

Training and inference run on the card (`--gpus k` picks cuda:k). With
several ordinals (`--gpus 0,1`) they run data parallel: one rank per
ordinal, started by `parallel.launch` and joined over NCCL.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from uresnet_pytorch_tpu_torch import main_funcs  # noqa: E402
from uresnet_pytorch_tpu_torch.flags import parse_args  # noqa: E402
from uresnet_pytorch_tpu_torch.parallel import launch  # noqa: E402


def main(argv=None, device="cuda"):
    mode, cfg = parse_args(argv)
    if mode in ("train", "inference") and len(cfg.gpus) > 1:
        # one rank per ordinal; on the CPU (device="cpu") gloo ranks
        launch(getattr(main_funcs, mode), len(cfg.gpus),
               cfg.gpus if device == "cuda" else (), args=(cfg, None, device))
    elif mode == "train":
        main_funcs.train(cfg, device=device)
    elif mode == "inference":
        main_funcs.inference(cfg, device=device)
    elif mode == "iotest":
        main_funcs.iotest(cfg)
    else:
        raise ValueError(mode)


if __name__ == "__main__":
    main()
