"""The port's launchers on the CPU (``--device cpu``, reduced configs),
held to the reference: ``repro_torch.launch.serve``'s greedy tokens to the
reference's ``make_serve_step`` on the same weights (converted), on its
baseline and its ``--optimized`` path (the ``ep`` dispatch for MoE, held
to the reference's dropless dispatch, which it equals at |model| = 1);
``repro_torch.launch.train``'s first step to the reference's train step
on the same weights and batch, and its checkpoint, written by
``python -m``, to the params of the same run in this process."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import models as jm  # noqa: E402
from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.data import DataConfig as RefDataConfig  # noqa: E402
from repro.data import make_pipeline as ref_pipeline  # noqa: E402
from repro.launch.mesh import make_debug_mesh as ref_debug_mesh  # noqa: E402
from repro.training import make_serve_step as ref_serve_step  # noqa: E402
from repro.training import make_train_step as ref_train_step  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.training import checkpoint  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOKENS, BATCH, CAPACITY = 6, 2, 16


def reference_tree(params):
    """The port's params as the reference's pytree."""
    out = {}
    for path, t in opt.leaves(params):
        node = out
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = jnp.asarray(t.detach().numpy())
    return out


@pytest.mark.parametrize("arch,optimized", [("mistral-nemo-12b", False),
                                            ("qwen3-moe-30b-a3b", True)])
def test_serve_launcher_tokens_match_the_reference(arch, optimized):
    argv = ["--arch", arch, "--device", "cpu", "--tokens", str(TOKENS), "--batch", str(BATCH),
            "--capacity", str(CAPACITY)] + (["--optimized"] if optimized else [])
    out = tserve.main(argv)
    rcfg = REF_ARCHS[arch].reduced(dtype="float32")
    # the reference's ep decode does not trace under its JAX (outside jit a
    # shard_map finds no mesh axis; under jax.set_mesh its scan's carry
    # changes type), so --optimized is held to its sorted dispatch: at
    # |model| = 1 ep drops nothing (capacity = T·K) and is the same function
    step, _ = ref_serve_step(
        rcfg, ref_debug_mesh(), impl="ref_grouped" if optimized else "ref",
        cache_update="onehot" if optimized else "scatter", moe_dispatch="sorted",
        donate=False)
    params = reference_tree(out["params"])
    cache = jm.init_cache(rcfg, BATCH, CAPACITY)
    tok, want = jnp.ones((BATCH,), jnp.int32), []
    for _ in range(TOKENS):
        logits, cache = step(params, cache, tok)
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        want.append(np.asarray(tok))
    np.testing.assert_array_equal(out["tokens"], np.stack(want))
    assert out["path"]["moe_dispatch"] == ("ep" if optimized else "sorted")


def test_serve_launcher_refuses_audio():
    with pytest.raises(SystemExit, match="enc-dec"):
        tserve.main(["--arch", "whisper-medium", "--device", "cpu"])


def test_train_launcher_first_step_matches_the_reference():
    arch, steps, batch, seq = "mistral-nemo-12b", 2, 2, 32
    out = ttrain.main(["--arch", arch, "--device", "cpu", "--steps", str(steps), "--batch",
                       str(batch), "--seq", str(seq)])
    assert out["impl"] == "auto" and len(out["losses"]) == steps
    cfg = ARCHS[arch].reduced(dtype="float32")
    rcfg = REF_ARCHS[arch].reduced(dtype="float32")
    params = reference_tree(init_params(cfg, torch.Generator().manual_seed(0), "cpu"))
    ocfg = jopt.AdamWConfig(lr=1e-3, warmup_steps=min(20, steps // 5 + 1), total_steps=steps)
    step, _ = ref_train_step(rcfg, ref_debug_mesh(), ocfg, remat=False)
    data = ref_pipeline(RefDataConfig(vocab=rcfg.vocab, seq_len=seq, global_batch=batch))
    _, _, metrics = step(params, jopt.init(params), {"tokens": jnp.asarray(next(data)["tokens"])})
    assert out["losses"][0] == pytest.approx(float(metrics["loss"]), rel=1e-5)


def test_train_launcher_writes_its_checkpoint(tmp_path):
    """``python -m repro_torch.launch.train`` with ``--ckpt``: the gathered
    params of the run, equal to the same run's in this process."""
    args = ["--arch", "mamba2-780m", "--device", "cpu", "--steps", "3", "--batch", "2",
            "--seq", "16", "--ckpt-every", "2"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    run = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args, "--ckpt",
                          str(tmp_path / "ck")], env=env, cwd=ROOT, capture_output=True,
                         text=True, timeout=240)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "checkpoint →" in run.stdout and "step     2" in run.stdout
    out = ttrain.main(args)
    template = {"params": dict(opt.leaves(out["params"]))}
    restored, meta = checkpoint.restore(str(tmp_path / "ck"), {"params": _nest(out["params"])})
    assert meta == {"step": 3}
    for path, want in template["params"].items():
        got = restored["params"]
        for k in path.split("/"):
            got = got[k]
        np.testing.assert_allclose(got.numpy(), want.full_tensor().detach().numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=path)


def _nest(params):
    out = {}
    for path, t in opt.leaves(params):
        node = out
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = t.full_tensor().detach()
    return out
