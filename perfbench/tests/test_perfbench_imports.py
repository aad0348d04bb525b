"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module name (the port's own name begins with the JAX
package's), and the reference loads nothing of the port."""

import json
import os
import subprocess
import sys

from perfbench.harness import cell as cells
from perfbench.run import FORBIDDEN, forbidden_modules


def _fresh(code: str) -> dict:
    env = dict(os.environ, PYTHONPATH=cells.ROOT)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=cells.ROOT,
                         capture_output=True, text=True, timeout=600, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_every_traffic_kind_runs_without_jax():
    names = [w["name"] for w in cells.manifest()["workloads"]]
    tops = _fresh(
        "import json, sys\n"
        "from perfbench.run import rehearsal\n"
        f"for n in {names!r}:\n"
        "    rehearsal(n, 5, 0.2)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    assert not set(tops) & set(FORBIDDEN), tops
    assert "deepxi_tpu_torch" in tops


def test_reference_imports_nothing_of_the_port():
    tops = _fresh(
        "import json, sys\n"
        "import perfbench.reference.dsp, perfbench.reference.networks, "
        "perfbench.reference.train\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    assert "deepxi_tpu_torch" not in tops and not set(tops) & set(FORBIDDEN)


def test_whole_name_comparison(monkeypatch):
    monkeypatch.setitem(sys.modules, "deepxi_tpu_torch_fake.sub", sys)
    assert "deepxi_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "deepxi_tpu.fake", sys)
    assert "deepxi_tpu" in forbidden_modules()
