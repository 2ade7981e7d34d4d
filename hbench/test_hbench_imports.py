"""No module of the benchmark loads ``jax``, ``jaxlib``, ``flax`` or the JAX
package ``repro`` (top-level names compared whole: ``repro_torch`` begins
with ``repro``), and the reference loads nothing of ``repro_torch`` either.
Each check runs in a fresh interpreter: the test process has JAX loaded."""
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_TOPS = ("import json, sys\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")


def _top_names(code: str) -> set[str]:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT), str(ROOT / "src")]))
    out = subprocess.run([sys.executable, "-c", code + _TOPS], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_every_module_of_the_benchmark_leaves_jax_and_repro_alone():
    modules = sorted(p.stem for p in (ROOT / "hbench").glob("*.py")
                     if not p.stem.startswith(("test_", "__")))
    code = "".join(f"import hbench.{m}\n" for m in modules)
    code += ("from hbench import spec\n"
             "for p in sorted((spec.ROOT / 'hbench' / 'metrics').glob('*.py')):\n"
             "    spec.metric_reader(p.stem)\n"
             "for p in sorted((spec.ROOT / 'hbench' / 'roofline').glob('*.py')):\n"
             "    spec.roofline(p.stem)\n"
             "import torch\n"
             "for p in sorted((spec.ROOT / 'hbench' / 'builders').glob('*.py')):\n"
             "    spec.builder(p.stem).build({'backend': 'scan'}, torch.zeros(64, 16),\n"
             "                               torch.device('cpu'))\n"
             "import hbench.run as r\n"
             "assert r.launch_counts() is not None\n")
    tops = _top_names(code)
    assert "repro_torch" in tops and "hbench" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_loads_nothing_of_the_program():
    tops = _top_names("import hbench.reference, hbench.compare\n")
    assert not tops & {"jax", "jaxlib", "flax", "repro", "repro_torch"}
