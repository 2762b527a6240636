"""The PyTorch port stands alone: importing it never pulls in JAX."""

import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "trueno_rag_tpu_torch"


def test_importing_the_port_leaves_jax_out():
    code = (
        "import sys\n"
        "import trueno_rag_tpu_torch, trueno_rag_tpu_torch.convert\n"
        "import trueno_rag_tpu_torch.ops.dense_tiered, trueno_rag_tpu_torch.ops.hybrid\n"
        "import trueno_rag_tpu_torch.models, trueno_rag_tpu_torch.ops.kernels.attention\n"
        "import trueno_rag_tpu_torch.ops.maxsim, trueno_rag_tpu_torch.ops.kernels.maxsim_scan\n"
        "import trueno_rag_tpu_torch.index.token_store, trueno_rag_tpu_torch.models.late_interaction\n"
        "import trueno_rag_tpu_torch.parallel, trueno_rag_tpu_torch.parallel.ingest, trueno_rag_tpu_torch.parallel.train\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'trueno_rag_tpu.')))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=str(ROOT), env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def test_no_port_source_names_jax_or_finished_kernels():
    banned = re.compile(
        r"^\s*(import jax|from jax|import trueno_rag_tpu\b|from trueno_rag_tpu\b(?!_torch))"
        r"|torch\.compile|scaled_dot_product_attention",
        re.M,
    )
    offenders = [
        str(p.relative_to(ROOT))
        for p in PKG.rglob("*.py")
        if banned.search(p.read_text())
    ]
    assert not offenders, offenders


def test_training_and_model_import_leave_reference_packages_out():
    """The training, Hugging Face import and device k-quant modules import
    none of JAX, the JAX package, transformers, safetensors, msgpack,
    orbax or optax (the card's machine has none of them)."""
    code = (
        "import sys\n"
        "import trueno_rag_tpu_torch.train, trueno_rag_tpu_torch.train.checkpoint\n"
        "import trueno_rag_tpu_torch.train.distill, trueno_rag_tpu_torch.models.hf_import\n"
        "import trueno_rag_tpu_torch.models.gguf_device, trueno_rag_tpu_torch.cli\n"
        "roots = ('jax', 'trueno_rag_tpu', 'transformers', 'safetensors', 'msgpack', 'orbax', 'optax')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in roots)\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_parallel_exports_match_jax():
    """``trueno_rag_tpu_torch.parallel`` exports the JAX package's names,
    ``encoder_param_specs`` included, plus the port's own ``Mesh`` type
    (the JAX package's is ``jax.sharding.Mesh``)."""
    import trueno_rag_tpu.parallel as jpar
    import trueno_rag_tpu_torch.parallel as ppar

    assert set(ppar.__all__) - {"Mesh"} == set(jpar.__all__)
    assert all(hasattr(ppar, name) for name in ppar.__all__)
    from trueno_rag_tpu_torch.parallel.mesh import shard_batch, shard_params  # noqa: F401
