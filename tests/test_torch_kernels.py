"""The port's kernel modules against the JAX kernels, on the CPU.

On CPU tensors each wrapper runs its kernel's plain version; the JAX kernels
run under ``interpret=True`` as ``tests/test_kernels.py`` runs them. The
same numpy inputs go to both. The CUDA kernels themselves are held against
the plain versions on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``). Tolerances: 2e-4 for float32, the JAX file's ``TOL`` for
bfloat16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.streamed_dot import streamed_dot as j_dot
from repro.kernels.streamed_matmul import streamed_matmul as j_matmul
from repro_torch.kernels import ops, pipeline, ref
from repro_torch.kernels.flash_attention import attention_plan
from repro_torch.kernels.streamed_dot import dot_plan
from repro_torch.kernels.streamed_matmul import matmul_plan, split_for, tile_for

TOL = {"float32": 2e-4, "bfloat16": 2e-1}


def _pair(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, getattr(jnp, dtype)), torch.as_tensor(x).to(getattr(torch, dtype))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol * 8)


@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (300, 200, 130), (64, 384, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_matches_jax_kernel(rng, m, k, n, dtype):
    ja, ta = _pair(rng, (m, k), dtype)
    jb, tb = _pair(rng, (k, n), dtype)
    want = j_matmul(ja, jb, block_m=128, block_n=128, block_k=128, interpret=True)
    got = ops.matmul(ta, tb)
    assert got.dtype == ta.dtype and got.shape == (m, n)
    _close(got, want, TOL[dtype])


def test_matmul_out_dtype(rng):
    ja, ta = _pair(rng, (64, 96), "bfloat16")
    jb, tb = _pair(rng, (96, 32), "bfloat16")
    want = j_matmul(ja, jb, block_m=64, block_n=32, block_k=32,
                    out_dtype=jnp.float32, interpret=True)
    got = ops.matmul(ta, tb, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    _close(got, want, TOL["float32"])


@pytest.mark.parametrize("n,c", [(1024, 256), (5000, 512), (100, 128)])
def test_dot_matches_jax_kernel(rng, n, c):
    jv, tv = _pair(rng, (n,), "float32")
    ju, tu = _pair(rng, (n,), "float32")
    want = float(j_dot(jv, ju, token_size=c, interpret=True))
    got = ops.dot(tv, tu, token_size=c)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert float(got) == pytest.approx(want, rel=1e-4, abs=1e-3)


@pytest.mark.parametrize("hq,hkv,sq,skv,causal", [
    (4, 4, 128, 128, True),        # MHA
    (8, 2, 96, 96, True),          # GQA, ragged blocks
    (4, 1, 1, 128, True),          # decode: queries at the end of the keys
    (4, 2, 64, 128, False),        # non-causal
])
def test_attention_matches_jax_kernel(rng, hq, hkv, sq, skv, causal):
    b, d = 2, 32
    jq, tq = _pair(rng, (b, hq, sq, d), "float32")
    jk, tk = _pair(rng, (b, hkv, skv, d), "float32")
    jv, tv = _pair(rng, (b, hkv, skv, d), "float32")
    want = j_flash(jq, jk, jv, causal=causal, block_q=32, block_kv=32, interpret=True)
    _close(ops.attention(tq, tk, tv, causal=causal), want, TOL["float32"])


def test_attention_bf16_matches_jax_kernel(rng):
    jq, tq = _pair(rng, (1, 2, 64, 32), "bfloat16")
    jk, tk = _pair(rng, (1, 2, 64, 32), "bfloat16")
    jv, tv = _pair(rng, (1, 2, 64, 32), "bfloat16")
    want = j_flash(jq, jk, jv, block_q=32, block_kv=32, interpret=True)
    got = ops.attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    _close(got, want, TOL["bfloat16"])


def test_attention_is_causal(rng):
    """Perturbing future keys must not change earlier outputs."""
    q, k, v = (torch.as_tensor(rng.standard_normal((1, 2, 64, 16)), dtype=torch.float32)
               for _ in range(3))
    out1 = ops.attention(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 40:], v2[:, :, 40:] = 99.0, -99.0
    torch.testing.assert_close(ops.attention(q, k2, v2)[:, :, :40], out1[:, :, :40])


def test_plain_versions_accumulate_in_fp32():
    a = torch.full((1, 4096), 1.0 / 256, dtype=torch.bfloat16)
    b = torch.ones((4096, 1), dtype=torch.bfloat16)
    assert float(ref.matmul_ref(a, b)) == 16.0       # a bf16 running sum would stall
    assert float(ref.dot_ref(a[0], b[:, 0])) == 16.0


def test_kernel_geometry_follows_the_plans():
    """The launch site maps parallel axes to the grid (last in x) and
    arbitrary axes to the per-block loop, for each kernel's plan."""
    mm = matmul_plan(1024, 2304, 5760, block_m=64, block_n=64, block_k=32)
    assert pipeline.geometry(mm) == ((90, 16, 1), 72)
    split = matmul_plan(4, 2304, 5760, block_m=16, block_n=64, block_k=64, split_k=6)
    assert pipeline.geometry(split) == ((90, 1, 6), 6)
    attn = attention_plan(4, 36, 36, 256, 256, 64, block_q=64, block_kv=64)
    assert pipeline.geometry(attn) == ((4, 36, 4), 4)
    assert attn.scratch_bytes == (2 * 64 + 64 * 64) * 4   # m, l, acc of the kernel
    assert pipeline.geometry(dot_plan(512, 8192, cores=128)) == ((128, 1, 1), 4)
    assert pipeline.geometry(dot_plan(16, 8192)) == ((1, 1, 1), 16)


def test_decode_tiles_and_split():
    assert tile_for(4) == (16, 64, 64) and tile_for(1024) == (64, 64, 32)
    # decode up/down projections of minicpm-2b on 132 SMs: the split fills the
    # card about four blocks deep and divides the K tiles
    assert split_for(90, 36, 132) == 6
    assert split_for(36, 90, 132) == 15
    assert split_for(16 * 90, 72, 132) == 1


def test_cpu_tensors_never_reach_the_library(rng, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the kernel library was touched for a CPU tensor")

    monkeypatch.setattr(pipeline, "library", boom)
    monkeypatch.setattr(pipeline, "launch", boom)
    before = ops.launch_counts()
    x = torch.as_tensor(rng.standard_normal((8, 64)), dtype=torch.float32)
    ops.matmul(x, x.T.contiguous())
    ops.dot(x[0], x[1])
    ops.attention(x[None, None], x[None, None], x[None, None])
    assert ops.launch_counts() == before     # the plain versions launch nothing


def test_wrappers_refuse_other_devices():
    x = torch.empty((4, 64), device="meta")
    with pytest.raises(ValueError):
        ops.matmul(x, x.T)
    with pytest.raises(ValueError):
        ops.dot(x[0], x[1])
    with pytest.raises(ValueError):
        ops.attention(x[None, None], x[None, None], x[None, None])
