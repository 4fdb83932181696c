"""Nothing the benchmark runs loads JAX or the JAX package. The check
compares top-level module names whole: ``juliagrid_tpu_torch`` is the port,
not the JAX package ``juliagrid_tpu``."""

import subprocess
import sys

from portbench.harness import FORBIDDEN

from .conftest import ROOT

PROBE = """
import sys
sys.path.insert(0, {root!r})
import portbench.run, portbench.harness, portbench.check
import portbench.control, portbench.reference.grid
from portbench.spec import Spec
spec = Spec()
for m in spec.doc["end_to_end"] + spec.doc["per_layer"]:
    spec.reader(m["name"])
for w in spec.doc["workloads"]:
    entry = spec.entry(spec.traffic(w["traffic"])["entry"])
import juliagrid_tpu_torch.parallel, juliagrid_tpu_torch.estimation.acse
from portbench.harness import forbidden_modules
print(sorted({{n.split(".")[0] for n in sys.modules}}
             & {{"jax", "jaxlib", "flax", "juliagrid_tpu",
                 "juliagrid_tpu_torch"}}))
print(forbidden_modules())
"""


def test_the_harness_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr
    held, forbidden = out.stdout.strip().splitlines()[-2:]
    assert held == "['juliagrid_tpu_torch']"
    assert forbidden == "[]"


def test_names_are_compared_whole():
    from portbench.harness import forbidden_modules
    assert forbidden_modules(["juliagrid_tpu_torch", "jaxtyping",
                              "juliagrid_tpu_torch.kernels.nr_fill"]) == []
    assert forbidden_modules(["juliagrid_tpu.ops", "jax.numpy", "numpy"]) \
        == ["jax", "juliagrid_tpu"]
    assert set(FORBIDDEN) == {"jax", "jaxlib", "flax", "juliagrid_tpu"}
