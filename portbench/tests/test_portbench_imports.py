"""What the benchmark loads: nothing of JAX or the JAX package, compared
by whole top-level module names (the port's name begins with the JAX
package's), and the references nothing of the port either."""

import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "labelany3d_tpu"}
REFERENCES = ["reference." + p.stem for p in (HERE / "reference").glob("*.py")
              if p.stem != "__init__"]


def loaded(imports: list[str]) -> set[str]:
    code = ("import sys, json; sys.path[:0] = [%r, %r]\n" % (str(HERE), str(HERE.parent))
            + "".join(f"import {m}\n" for m in imports)
            + "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=HERE.parent, env={"PATH": "/usr/bin:/bin"})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_drivers_load_no_jax():
    names = loaded(["run", "drivers.train", "drivers.label", "tools.controls"]
                   + REFERENCES)
    assert not names & FORBIDDEN


def test_drivers_load_the_port_but_not_the_jax_package():
    names = loaded(["drivers.label", "labelany3d_tpu_torch.pipeline.stages.fused",
                    "labelany3d_tpu_torch.parallel.train"])
    assert "labelany3d_tpu_torch" in names
    assert not names & FORBIDDEN


def test_references_load_nothing_of_the_port():
    names = loaded(REFERENCES + ["gen.depth_scenes", "gen.coconut_split", "common.arith",
                                 "common.weights", "common.checks", "common.flops"])
    assert not names & (FORBIDDEN | {"labelany3d_tpu_torch"})
    assert len(REFERENCES) >= 15


def test_forbidden_check_compares_whole_names(monkeypatch):
    from common import env

    monkeypatch.setitem(sys.modules, "labelany3d_tpu_torch_fake", object())
    assert "labelany3d_tpu_torch_fake" not in env.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax.numpy" in env.forbidden_loaded()
