"""Import guard of the PyTorch port: no module of ct_clip_tpu_torch, and not
chip_smoke.py, imports jax, flax, optax, scikit-learn or the JAX package,
anywhere in the file (top level or inside a function); the machine with the
card has none of them.  Parsed with `ast`, nothing is imported."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "ct_clip_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "flax", "optax", "sklearn", "ct_clip_tpu")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_files_are_found():
    assert len(FILES) >= 25
    assert ROOT / "ct_clip_tpu_torch" / "cli.py" in FILES
    assert ROOT / "ct_clip_tpu_torch" / "train" / "text_classifier.py" in FILES
    for name in ("visual_ssl.py", "mlm.py"):
        assert ROOT / "ct_clip_tpu_torch" / "models" / name in FILES
    for rel in ("train/ctvit_trainer.py", "data/generatect.py", "models/maskgit.py",
                "models/t5_encoder.py", "models/t5.py", "models/pipeline.py",
                "train/maskgit_trainer.py"):
        assert ROOT / "ct_clip_tpu_torch" / rel in FILES


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in BANNED]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
