"""Nothing the benchmark loads is JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
nothing of it reads the JAX package's harness (`bench.py`,
`benchmarks/`)."""

import re
import subprocess
import sys

from perfbench.core.cells import BENCH, ROOT

PROBE = r"""
import sys
sys.path.insert(0, {root!r})
from perfbench.tests import tiny
tiny.execute("sparse16_infer_b8")
tiny.execute("dense16_train_b8")
from perfbench import calibrate, run
print("FOUND", run.forbidden_modules())
"""


def test_a_run_loads_no_jax():
    res = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=600,
                         cwd=str(ROOT))
    assert res.returncode == 0, res.stderr[-3000:]
    assert "FOUND []" in res.stdout, res.stdout[-2000:]


def test_forbidden_names_compared_whole():
    from perfbench import run
    saved = dict(sys.modules)
    try:
        sys.modules["uresnet_pytorch_tpu_torch_probe"] = sys
        assert run.forbidden_modules() == []
        sys.modules["jax.numpy"] = sys
        assert run.forbidden_modules() == ["jax.numpy"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_sources_import_neither_jax_nor_the_jax_harness():
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|"
                     r"uresnet_pytorch_tpu|benchmarks|bench)\b(?!_torch)",
                     re.M)
    opens = re.compile(r"""["'](\.\./)?(bench\.py|benchmarks/)""")
    for path in BENCH.rglob("*.py"):
        text = path.read_text()
        assert not bad.search(text), path
        assert not opens.search(text), path
