"""The port stands alone: importing it pulls in neither JAX nor nsa_tpu, no
source of it imports them (or ml_dtypes, or optax, transformers and
safetensors, which the machine with the card lacks), and importing builds
nothing."""

import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|nsa_tpu|optax|transformers|safetensors)\b|ml_dtypes", re.M)


def test_import_leaves_jax_and_nsa_tpu_out():
    code = (
        "import sys\n"
        "import nsa_tpu_torch, nsa_tpu_torch.models.transformer\n"
        "import nsa_tpu_torch.eval.efficiency, nsa_tpu_torch.utils.checkpoint\n"
        "import nsa_tpu_torch.serve, nsa_tpu_torch.serve_bench\n"
        "import nsa_tpu_torch.bench, nsa_tpu_torch.ops.cuda.flash\n"
        "import nsa_tpu_torch.parallel.mesh, nsa_tpu_torch.parallel.comm\n"
        "import nsa_tpu_torch.parallel.sharding, nsa_tpu_torch.parallel.train_step\n"
        "import nsa_tpu_torch.train.continuous_pretrain\n"
        "import nsa_tpu_torch.parallel.context, nsa_tpu_torch.parallel.scaling_bench\n"
        "import nsa_tpu_torch.models.adapter, nsa_tpu_torch.models.llama_import\n"
        "import nsa_tpu_torch.train.finetune, nsa_tpu_torch.train.finetune_cs441\n"
        "import nsa_tpu_torch.train.task_data, nsa_tpu_torch.train.data_collection\n"
        "import nsa_tpu_torch.eval.finetune_eval\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'nsa_tpu', 'ml_dtypes', 'triton', 'optax', 'transformers', "
        "'safetensors'))\n"
        "print(','.join(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("tree", ["nsa_tpu_torch", "chip_smoke.py"])
def test_no_source_imports_jax_or_nsa_tpu(tree):
    path = os.path.join(ROOT, tree)
    files = [path] if path.endswith(".py") else [
        os.path.join(d, f) for d, _, fs in os.walk(path) for f in fs
        if f.endswith((".py", ".cu", ".cuh"))
    ]
    assert files
    for f in files:
        with open(f) as fh:
            hit = FORBIDDEN.search(fh.read())
        assert hit is None, f"{f}: {hit.group(0)!r}"
