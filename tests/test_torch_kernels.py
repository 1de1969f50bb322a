"""The port's kernel modules against the JAX kernels, on the CPU.

On CPU tensors each wrapper runs its kernel's plain version; the JAX kernels
run under ``interpret=True`` as ``tests/test_kernels.py`` runs them. The
same numpy inputs go to both. The CUDA kernels themselves are held against
the plain versions on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``). Tolerances: 2e-4 for float32, the JAX file's ``TOL`` for
bfloat16 (the selective scan's bf16 output: two bf16 ulps of its largest
value, one from each side's final rounding).
"""

import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bsp as jbsp
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.ssm_scan import ssm_plan as j_ssm_plan
from repro.kernels.ssm_scan import ssm_scan as j_ssm
from repro.kernels.streamed_dot import streamed_dot as j_dot
from repro.kernels.streamed_matmul import matmul_plan as j_matmul_plan
from repro.kernels.streamed_matmul import streamed_matmul as j_matmul
from repro_torch.core import bsp as tbsp
from repro_torch.kernels import ops, pipeline, ref
from repro_torch.kernels.flash_attention import (
    HEAD_DIMS,
    attention_bwd_plans,
    attention_plan,
    bwd_cost,
    bwd_tiles,
    causal_pairs,
    flash_attention_bwd,
    kernel_head_dim,
    pad_head_dim,
)
from repro_torch.kernels.ssm_scan import (
    bwd_geometry,
    launch_geometry,
    lanes_for,
    ssm_plan,
    ssm_scan,
)
from repro_torch.kernels.streamed_dot import dot_plan
from repro_torch.kernels.streamed_matmul import (
    DECODE_A_MAX,
    SM_SMEM,
    VARIANTS,
    decode_fits,
    decode_plan,
    decode_split,
    _deep_blocks_per_sm,
    deep_split,
    forced_variant,
    matmul_plan,
    streamed_matmul,
    tma_rows,
    variant_for,
)

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


def test_kernel_head_dim():
    """The head dim each D runs at on the card: itself where the kernel is
    built for it, else the next built one; past 256 a ValueError."""
    assert [kernel_head_dim(d) for d in (1, 8, 16, 17, 48, 64, 96, 128, 160, 192, 200, 256)] \
        == [16, 16, 16, 32, 64, 64, 128, 128, 192, 192, 256, 256]
    assert all(kernel_head_dim(d) == d for d in HEAD_DIMS)
    with pytest.raises(ValueError, match="256"):
        kernel_head_dim(257)


@pytest.mark.parametrize("d", [8, 12, 48, 96, 200])
@pytest.mark.parametrize("causal", [True, False])
def test_head_dim_padding_is_exact(rng, d, causal):
    """The card's padding as plain algebra: Q, K, V zero-padded to the
    kernel's head dim, attention at the unpadded D's ``sm_scale``, the
    output cut back, equal to the unpadded attention and its lse within
    1e-6 (GQA 4/2, queries at the end of the keys)."""
    q, k, v = (torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)
               for shape in ((2, 4, 40, d), (2, 2, 72, d), (2, 2, 72, d)))
    want, want_lse = ref.attention_ref_lse(q, k, v, causal=causal, sm_scale=d ** -0.5)
    dk = kernel_head_dim(d)
    padded = [pad_head_dim(t, dk) for t in (q, k, v)]
    assert all(t.shape[-1] == dk and torch.equal(t[..., :d], s) and not t[..., d:].any()
               for t, s in zip(padded, (q, k, v)))
    out, lse = ref.attention_ref_lse(*padded, causal=causal, sm_scale=d ** -0.5)
    assert not out[..., d:].any()
    torch.testing.assert_close(out[..., :d], want, rtol=0, atol=1e-6)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-6)


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
    mm = matmul_plan(1024, 2304, 5760, block_m=128, block_n=128, block_k=64)
    assert pipeline.geometry(mm) == ((45, 8, 1), 36)
    assert mm.scratch_bytes == 128 * 128 * 4   # the accumulator the wgmma kernel keeps
    split = matmul_plan(4, 2304, 5760, block_m=16, block_n=64, block_k=64, split_k=6)
    assert pipeline.geometry(split) == ((90, 1, 6), 6)
    attn = attention_plan(4, 36, 36, 256, 256, 64, block_q=64, block_kv=64)
    assert pipeline.geometry(attn) == ((4, 36, 4), 4)
    assert attn.scratch_bytes == (2 * 64 + 64 * 64) * 4   # m, l, acc of the kernel
    assert pipeline.geometry(dot_plan(512, 8192, cores=128)) == ((128, 1, 1), 4)
    assert pipeline.geometry(dot_plan(16, 8192)) == ((1, 1, 1), 16)


@pytest.mark.parametrize("d,tiles", [(16, (64, 64, 1)), (32, (64, 64, 1)), (64, (64, 64, 1)),
                                     (128, (64, 32, 1)), (192, (32, 32, 2)), (256, (32, 32, 2))])
def test_flash_bwd_tiles(d, tiles):
    """The backward's tiles a head dim (``BwdTile`` in the CUDA source):
    pass A's keys a step, pass B's queries a step and column splits."""
    assert bwd_tiles(d) == tiles


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("b,hq,hkv,sq,skv", [(8, 36, 36, 2048, 2048), (4, 32, 8, 256, 256),
                                             (1, 8, 2, 100, 300), (2, 4, 2, 20, 90)])
def test_flash_bwd_geometry_follows_the_plans(b, hq, hkv, sq, skv, d):
    """The backward's two plans lower to what its C entries check: pass A a
    block a (Q tile of 64, q head, batch) looping over the KV blocks of its
    tile, its scratch the dq accumulator; pass B a block a (KV block of 64,
    kv head, batch) looping over the group's heads × Q tiles, its scratch
    the dk and dv accumulators. Each plan pads (sq, skv) to its own tiles."""
    nk, qb, _ = bwd_tiles(d)
    dq_plan, dkv_plan = attention_bwd_plans(b, hq, hkv, sq, skv, d, q_offset=skv - sq)
    assert pipeline.geometry(dq_plan) == ((-(-sq // 64), hq, b), -(-skv // nk))
    assert pipeline.geometry(dkv_plan) == ((-(-skv // 64), hkv, b), hq // hkv * -(-sq // qb))
    assert dq_plan.scratch_bytes == 64 * d * 4
    assert dkv_plan.scratch_bytes == 2 * 64 * d * 4


def test_flash_bwd_plans_skip_above_the_diagonal():
    """Causal hypersteps wholly above the diagonal cost nothing: pass A's
    Q tile 0 stops at KV block 0, pass B's KV block 3 starts at Q tile 3;
    without causal masking every hyperstep computes."""
    dq_plan, dkv_plan = attention_bwd_plans(1, 2, 2, 256, 256, 64)
    assert dq_plan.flops_per_hyperstep(0, 0, 0, 0) == 6.0 * 64 * 64 * 64
    assert dq_plan.flops_per_hyperstep(0, 0, 0, 1) == 0.0
    assert dkv_plan.flops_per_hyperstep(0, 0, 3, 0, 2) == 0.0
    assert dkv_plan.flops_per_hyperstep(0, 0, 3, 0, 3) == 8.0 * 64 * 64 * 64
    assert dq_plan.mean_flops_per_hyperstep == 6.0 * 64 ** 3 * 10 / 16
    dq_full, _ = attention_bwd_plans(1, 2, 2, 256, 256, 64, causal=False)
    assert dq_full.flops_per_hyperstep(0, 0, 0, 3) == 6.0 * 64 ** 3


def test_flash_bwd_cost_counts_ten_d_a_kept_pair():
    """The backward's counted work: 10·d operations a kept pair (the
    harness's frozen count), minicpm-2b's train-step layer 386.7 GFLOP;
    Q, K, V, O, dO and lse read, dQ, dK, dV written once."""
    c = bwd_cost(8, 36, 36, 2048, 2048, 64, 2)
    assert c.flops == 10.0 * 8 * 36 * 64 * causal_pairs(2048, 2048)
    assert round(c.flops / 1e9, 1) == 386.7 and c.kind == "bf16"
    assert c.bytes == (4 * 8 * 36 * 2048 * 64 + 4 * 8 * 36 * 2048 * 64) * 2 + 4 * 8 * 36 * 2048
    assert bwd_cost(1, 4, 2, 10, 30, 16, 2, causal=False).flops == 10.0 * 4 * 16 * 300


def test_flash_attention_bwd_takes_only_card_tensors():
    """The backward kernel's wrapper has no CPU path (its plain version is
    ``models/flash._flash_bwd``): CPU and meta tensors and bad shapes raise
    before the library is touched, and nothing is counted."""
    before = ops.launch_counts()["flash_attention_bwd"]
    for device in ("cpu", "meta"):
        q = torch.zeros((1, 2, 8, 16), dtype=torch.bfloat16, device=device)
        lse = torch.zeros((1, 2, 8), device=device)
        with pytest.raises(ValueError, match="CUDA"):
            ops.attention_bwd(q, q, q, q, lse, q)
    q = torch.zeros((1, 2, 8, 16), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="shapes"):
        flash_attention_bwd(q, q, q, q, torch.zeros((1, 2, 9), device="meta"), q)
    with pytest.raises(ValueError, match="multiple"):
        kv = torch.zeros((1, 3, 8, 16), dtype=torch.bfloat16, device="meta")
        flash_attention_bwd(q[:, :2], kv, kv, q, torch.zeros((1, 2, 8), device="meta"), q)
    assert ops.launch_counts()["flash_attention_bwd"] == before


def test_decode_tiles_and_split():
    assert VARIANTS[variant_for(4, 0, 2304, 0, 5760, 2304)] == (16, 128, 64)
    assert variant_for(4, 0, 2304, 0, 5761, 2304) == "decode_cp"
    assert VARIANTS["decode_cp"] == (16, 128, 64)
    assert VARIANTS[variant_for(1024, 0, 2304, 0, 5760, 2304)] == (128, 128, 64)
    assert variant_for(1024, 0, 37, 0, 5760, 37) == "wgmma_cp"
    assert VARIANTS["wgmma_cp"] == (128, 128, 64)
    # decode_cp takes decode_deep's split: one per instance, the same for
    # every m of 1 .. 8 and of 9 .. 16 (minicpm's up projection one column
    # wider, and nemotron's down projection, on 132 SMs)
    for k, n in ((2304, 5761), (73728, 18433)):
        for rows in (range(1, 9), range(9, 17)):
            assert len({deep_split(m, n, k, 132) for m in rows}) == 1
    assert deep_split(4, 5761, 2304, 132) == 6


def _bf16(shape):
    return torch.empty(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("case,want", [
    ("decode", "decode"),              # m ≤ 16, B TMA-describable
    ("decode_odd_lda", "decode"),      # A's rows 194 bytes apart: A takes plain loads
    ("decode_odd_ldb", "decode_cp"),   # n = 9: B's rows 18 bytes apart
    ("decode_deep_k", "decode_deep"),  # m 16, k 65536: A's K share overflows a block
    ("forward", "wgmma"),              # minicpm's up projection
    ("odd_ldb", "wgmma_cp"),           # n = 130: B's rows 260 bytes apart
    ("odd_lda", "wgmma_cp"),           # k = 37: A's rows 74 bytes apart
    ("sliced_rows", "wgmma_cp"),       # A a column slice, row stride 100 elements
    ("wide_slice", "wgmma"),           # A a column slice, row stride 96 (192 bytes)
    ("offset_base", "wgmma_cp"),       # A starts one element into its buffer
])
def test_variant_for(case, want):
    """The variant rule reads only m, k, the base addresses and the row
    strides: TMA needs 16-byte aligned bases and rows a multiple of 16 bytes
    apart."""
    m, k, n = {"decode": (4, 2304, 5760), "odd_ldb": (300, 200, 130),
               "odd_lda": (64, 37, 64), "decode_odd_lda": (4, 64, 64),
               "decode_odd_ldb": (1, 37, 9), "decode_deep_k": (16, 65536, 128),
               }.get(case, (1024, 2304, 5760))
    a, b = _bf16((m, k)), _bf16((k, n))
    if case == "decode_odd_lda":
        a = _bf16((m, 97))[:, :64]
    elif case == "sliced_rows":
        a = _bf16((m, 100))[:, :64]
    elif case == "wide_slice":
        a = _bf16((m, 96))[:, :64]
    elif case == "offset_base":
        a = _bf16((m * k + 1,))[1:].view(m, k)
    assert variant_for(m, a.data_ptr(), a.stride(0), b.data_ptr(), b.stride(0), k) == want


_DEFAULT, _NK, _KM = ("mk", "kn"), ("mk", "nk"), ("km", "kn")


@pytest.mark.parametrize("forced,picked,layouts,want", [
    (None, "decode", _DEFAULT, "decode"),             # no forced name: the rule's
    (None, "wgmma_cp", _DEFAULT, "wgmma_cp"),
    ("wgmma", "wgmma", _NK, "wgmma"),                 # the rule's own name, any layout
    ("decode_cp", "decode_cp", _DEFAULT, "decode_cp"),
    ("decode_cp", "decode", _DEFAULT, "decode_cp"),   # the copy producers on TMA's operands
    ("decode_cp", "decode_deep", _DEFAULT, "decode_cp"),
    ("wgmma_cp", "wgmma", _DEFAULT, "wgmma_cp"),
    ("decode_cp", "decode", _NK, ValueError),         # the copy variants: default layouts only
    ("decode_cp", "decode_deep", _NK, ValueError),
    ("wgmma_cp", "wgmma", _NK, ValueError),
    ("wgmma_cp", "wgmma", _KM, ValueError),
    ("decode_cp", "wgmma", _DEFAULT, ValueError),     # m > 16 is not a decode product
    ("wgmma_cp", "decode", _DEFAULT, ValueError),
    ("wgmma_cp", "decode_cp", _DEFAULT, ValueError),
    ("decode_cp", "wgmma_cp", _DEFAULT, ValueError),
    ("decode_deep", "decode", _DEFAULT, ValueError),  # only the copy variants are forced
    ("decode", "decode_cp", _DEFAULT, ValueError),
    ("wgmma", "wgmma_cp", _DEFAULT, ValueError),
    ("simt_f32", "wgmma", _DEFAULT, ValueError),
    ("decode_wmma", "decode", _DEFAULT, ValueError),  # the retired names
    ("wmma", "wgmma", _DEFAULT, ValueError),
])
def test_forced_variant_rule(forced, picked, layouts, want):
    """Which forced names a picked variant and its layouts accept: a copy
    variant runs where the rule gives the TMA variant it mirrors, in the
    default layouts; anything else raises."""
    if want is ValueError:
        with pytest.raises(ValueError, match="cannot take"):
            forced_variant(forced, picked, *layouts)
    else:
        assert forced_variant(forced, picked, *layouts) == want


def test_the_matmul_has_six_variants():
    """``VARIANTS``, the launch counts and their reset name the same six
    variants: the copy producers replace the wmma ones."""
    six = {"decode", "decode_deep", "decode_cp", "wgmma", "wgmma_cp", "simt_f32"}
    assert set(VARIANTS) == six
    assert set(streamed_matmul.launches_by_variant) == six
    ops.reset_launch_counts()
    assert set(ops.matmul_variant_counts()) == six


@pytest.mark.parametrize("kernel", ["matmul", "flash", "flash_bwd", "scan_bwd"])
def test_time_kernels_refuses_to_run_without_a_card(kernel, monkeypatch, capsys):
    """The parent/change timer times only on the card: without one it exits
    with its reason before it makes any input."""
    from repro_torch.launch import time_kernels

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.argv", ["time_kernels.py", "--kernel", kernel])
    with pytest.raises(SystemExit, match="no CUDA device"):
        time_kernels.main()
    assert capsys.readouterr().out == ""


# (m, k, n) -> cluster size on 132 SMs: the largest split whose blocks fill
# at most 7/8 of the card's slots at once, raised until A's K share fits —
# the share of 8 rows for every m ≤ 8, so that m = 1 .. 8 take one split
@pytest.mark.parametrize("m,k,n,split", [
    (4, 2304, 5760, 6),        # minicpm up/gate: 45 column tiles, 36 K tiles, 3 blocks an SM
    (4, 5760, 2304, 8),        # minicpm down: 18 tiles
    (4, 4096, 14336, 2),       # jamba up/gate: 112 tiles, 2 blocks an SM
    (4, 14336, 4096, 7),       # jamba down: 32 tiles
    (4, 4096, 65536, 2),       # jamba's LM head: 512 tiles overfill the card, and 8
                               # rows' share of all 64 K tiles (65,664 B) overflows
    (16, 4096, 14336, 3),      # 16 rows: 1 or 2 shares would hold 131 or 66 KB of A
    (16, 14336, 4096, 8),
    (16, 1000, 1032, 8),       # ragged: 16 K tiles, two each
    (1, 100, 64, 2),           # two K tiles
])
def test_decode_split(m, k, n, split):
    assert decode_split(m, n, k, 132) == split
    assert decode_fits(m, k)
    k_tiles = -(-k // 64)
    per = -(-k_tiles // split)
    assert (split - 1) * per < k_tiles <= split * per       # no empty share
    assert m * (per * 64 + 8) * 2 <= DECODE_A_MAX


def test_decode_fits_bounds_the_a_share():
    assert decode_fits(16, 8 * 15 * 128) and not decode_fits(16, 8 * 16 * 128)
    # sized for 8 rows whatever m ≤ 8: 63 K tiles a block fit, 64 do not
    assert decode_fits(4, 8 * 63 * 64) and not decode_fits(4, 8 * 63 * 64 + 64)
    assert {decode_fits(m, 32320) for m in range(1, 9)} == {False}


def test_decode_past_the_a_share_takes_one_variant():
    """Where 8 rows' K share fits no split, every m ≤ 8 takes decode_deep
    (one summation order for all of them) and decode_split raises."""
    k = 8 * 63 * 64 + 64
    assert {variant_for(m, 0, k, 0, 4096, k) for m in range(1, 9)} == {"decode_deep"}
    with pytest.raises(ValueError, match="overflows a decode block"):
        decode_split(1, 4096, k, 132)


# (m, k, n, b_layout) -> decode_deep's cluster size on 132 SMs: the deep-K
# decode products (nemotron-4-340b's down projection at 1, 4 and 8 rows; at
# 16 rows its up projection, starcoder2-15b's and qwen2-vl-7b's down
# projections, nemotron's head with B as (k, n) and as (n, k)). Three 70 or
# 75 KB blocks an SM: 346 of 396 slots, so 144 column tiles take 2
@pytest.mark.parametrize("m,k,n,b_layout,split", [
    (1, 73728, 18432, "kn", 2), (4, 73728, 18432, "kn", 2), (8, 73728, 18432, "kn", 2),
    (16, 18432, 73728, "kn", 1), (16, 24576, 6144, "kn", 7), (16, 18944, 3584, "kn", 8),
    (16, 18432, 256000, "kn", 1), (16, 18432, 256000, "nk", 1),
])
def test_deep_split(m, k, n, b_layout, split):
    ldb = n if b_layout == "kn" else k
    assert variant_for(m, 0, k, 0, ldb, k, b_layout=b_layout) == "decode_deep"
    assert deep_split(m, n, k, 132) == split
    k_tiles = -(-k // 64)
    per = -(-k_tiles // split)
    assert (split - 1) * per < k_tiles <= split * per       # no empty share
    rows = 8 if m <= 8 else 16
    # one K split (one summation order) for every m of the kernel instance
    assert {deep_split(r, n, k, 132) for r in range(rows - 7, rows + 1)} == {split}
    plan = decode_plan(m, k, n, split, deep=True)
    assert plan.grid == (-(-n // 128), split, per)
    # the ring of 16 KB weight stages and 4 stages of A slices of `rows` rows
    assert plan.scratch_bytes == 4 * 64 * 128 * 2 + 4 * rows * 72 * 2
    blocks = _deep_blocks_per_sm(m)
    assert blocks == 3 and blocks * (plan.scratch_bytes + 1024 + 64 + 1024) <= SM_SMEM
    assert 8 * plan.grid[0] * split <= 7 * 132 * blocks or split == 1


def test_deep_plan_streams_a_beside_b():
    """decode_deep's A is a token of the K stream, (m, 64) at hyperstep s,
    where the decode variant holds each block's whole K share."""
    deep, share = decode_plan(4, 73728, 18432, 2, deep=True), decode_plan(4, 2304, 5760, 6)
    assert deep.inputs[0].block_shape == (4, 64) and deep.inputs[1].block_shape == (64, 128)
    assert deep.inputs[0].index_map(3, 1, 5) == (0, 576 + 5)
    assert deep.inputs[1].index_map(3, 1, 5) == (576 + 5, 3)
    assert share.inputs[0].block_shape == (4, 6 * 64)
    assert deep.fingerprint() != decode_plan(4, 73728, 18432, 2, deep=False).fingerprint()


@pytest.mark.parametrize("k,n", [(2304, 2304), (2304, 5760), (5760, 2304), (2304, 122753),
                                 (4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
                                 (4096, 65536)])
def test_decode_split_is_one_for_rows_1_to_8(k, n):
    """A packed decode step's rows sum in the order each row alone does:
    m = 1 .. 8 take one K split (and m = 9 .. 16 one of their own)."""
    assert len({decode_split(m, n, k, 132) for m in range(1, 9)}) == 1
    assert len({decode_split(m, n, k, 132) for m in range(9, 17)}) == 1


@pytest.mark.parametrize("m,k,n,a_layout,b_layout,ldb,want", [
    (8, 2304, 122753, "mk", "nk", 2304, "decode"),      # the tied head in decode
    (1024, 2304, 122753, "mk", "nk", 2304, "wgmma"),    # the tied head's forward
    (1024, 5760, 2304, "mk", "nk", 5760, "wgmma"),      # dX = dC·Wᵀ
    (2304, 1024, 5760, "km", "kn", 5760, "wgmma"),      # dW = Xᵀ·dC
    (8, 2304, 5760, "km", "kn", 5760, "wgmma"),         # a (k, m) A at any m
    (8, 64, 9, "mk", "nk", 67, ValueError),             # B's rows 134 bytes apart
    (300, 64, 9, "mk", "nk", 67, ValueError),
    (64, 37, 64, "km", "kn", 64, ValueError),           # A's rows 74 bytes apart
    (64, 64, 64, "km", "nk", 64, ValueError),           # one transposed operand at a time
])
def test_variant_for_layouts(m, k, n, a_layout, b_layout, ldb, want):
    """A transposed operand takes a TMA variant (decode for an (n, k) B at
    m ≤ 16, wgmma otherwise) or raises: the copy variants read the default
    layouts only. ``lda``/``ldb`` are the stored rows' strides."""
    lda = 37 if (m, k) == (64, 37) else (k if a_layout == "mk" else m)
    if want is ValueError:
        with pytest.raises(ValueError):
            variant_for(m, 0, lda, 0, ldb, k, a_layout=a_layout, b_layout=b_layout)
    else:
        assert variant_for(m, 0, lda, 0, ldb, k, a_layout=a_layout, b_layout=b_layout) == want


@pytest.mark.parametrize("a_layout,b_layout", [("mk", "kn"), ("mk", "nk"), ("km", "kn")])
def test_matmul_layouts_on_the_cpu(rng, a_layout, b_layout):
    """The CPU path (the plain version) reads each stored operand in its
    layout, and the wrapper takes the shapes from the layouts."""
    m, k, n = 5, 7, 3
    a = torch.as_tensor(rng.standard_normal((m, k) if a_layout == "mk" else (k, m)),
                        dtype=torch.float32)
    b = torch.as_tensor(rng.standard_normal((k, n) if b_layout == "kn" else (n, k)),
                        dtype=torch.float32)
    want = (a if a_layout == "mk" else a.T) @ (b if b_layout == "kn" else b.T)
    got = ops.matmul(a, b, a_layout=a_layout, b_layout=b_layout)
    torch.testing.assert_close(got, want)
    with pytest.raises(ValueError):      # B read in the other layout: k does not match
        ops.matmul(a, b, a_layout=a_layout, b_layout="nk" if b_layout == "kn" else "kn")


def test_tma_rows_pads_only_what_tma_cannot_read():
    """The backward's staging: rows 122,753 bf16 apart are copied to rows
    122,760 apart (a view of the first 122,753), aligned ones pass as they
    are."""
    odd = torch.randn(3, 122753).to(torch.bfloat16)
    padded = tma_rows(odd)
    assert padded.shape == odd.shape and padded.stride() == (122760, 1)
    assert torch.equal(padded, odd)
    even = torch.randn(3, 64).to(torch.bfloat16)
    assert tma_rows(even) is even


def test_decode_plan_geometry():
    """The decode plan: grid (column tiles, split, K tiles per split), the
    split in x so that a cluster along x holds one column tile's shares;
    every weight word streams once, A's share once per block, C once per
    tile; scratch = the 4-stage ring of 64 × 128 stages and the A share."""
    assert VARIANTS["decode"] == (16, 128, 64)
    plan = decode_plan(4, 2304, 5760, 6)
    assert pipeline.geometry(plan) == ((6, 45, 1), 6)
    assert plan.scratch_bytes == 4 * 64 * 128 * 2 + 4 * (6 * 64 + 8) * 2
    assert _fetched_words(plan, ("B",)) == 2304 * 5760
    assert _fetched_words(plan, ("A",)) == 45 * 4 * 2304
    assert sum(plan.writeback_schedule()) == 4 * 5760
    assert plan.total_flops == 2.0 * 4 * 2304 * 5760
    ragged = decode_plan(16, 1000, 1032, 8)
    assert pipeline.geometry(ragged) == ((8, 9, 1), 2)
    with pytest.raises(ValueError):
        decode_plan(4, 1000, 1032, 9)           # past the cluster limit
    with pytest.raises(ValueError):
        decode_plan(4, 576, 64, 8)              # 9 K tiles in 2s: the last share empty


@pytest.mark.parametrize("m,k,n", [(1024, 2304, 5760), (1024, 5760, 2304), (1024, 4096, 14336),
                                   (1024, 14336, 4096), (1024, 4096, 65536), (1000, 2304, 5768)])
def test_wgmma_tile_plan_is_the_jax_plan(m, k, n):
    """At the wgmma variant's 128×128×64 blocks the port's plan is the JAX
    package's: the same grid, fingerprint and Eq. 1 price on every pack."""
    tp = matmul_plan(m, k, n, block_m=128, block_n=128, block_k=64, dtype=torch.bfloat16)
    jp = j_matmul_plan(m, k, n, block_m=128, block_n=128, block_k=64, dtype=jnp.bfloat16)
    assert tp.grid == jp.grid and tp.dimension_semantics == jp.dimension_semantics
    assert tp.fingerprint() == jp.fingerprint()
    assert tp.vmem_bytes == jp.vmem_bytes and tp.total_flops == jp.total_flops
    for jacc in (jbsp.EPIPHANY_III, jbsp.TPU_V5E_CHIP, jbsp.TPU_V5E_POD):
        assert tp.cost(_pack(jacc)) == jp.cost(jacc)
        assert tp.cost(_pack(jacc), exact=False) == jp.cost(jacc, exact=False)


@pytest.mark.parametrize("m,k,lda", [(1, 64, 64), (4, 4096, 4096), (16, 37, 37),
                                     (1024, 4096, 4096), (4096, 4096, 4097)])
def test_fp32_operands_take_the_simt_variant(m, k, lda):
    """fp32 operands take ``simt_f32`` at any m, whatever the strides (the
    bf16 rule's TMA alignment, 2 bytes an element, is not consulted), in
    every layout: the kernel copies a k-contiguous operand transposed."""
    assert variant_for(m, 4, lda, 4, 9, k, dtype=torch.float32) == "simt_f32"
    assert VARIANTS["simt_f32"] == (256, 128, 32)
    for a_layout, b_layout in (("mk", "nk"), ("km", "kn")):
        assert variant_for(m, 4, lda, 4, 9, k, a_layout=a_layout, b_layout=b_layout,
                           dtype=torch.float32) == "simt_f32"


@pytest.mark.parametrize("m,k,n", [(4096, 4096, 4096), (1000, 264, 1032), (4, 2304, 5760)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_fp32_tile_plan_is_the_jax_plan(m, k, n, out_dtype):
    """The plan the fp32 variant launches (256×128×32, fp32 operands) is the
    JAX package's fp32 plan at those blocks: grid, fingerprint, Eq. 1 price."""
    bm, bn, bk = VARIANTS["simt_f32"]
    tp = matmul_plan(m, k, n, block_m=bm, block_n=bn, block_k=bk, dtype=torch.float32,
                     out_dtype=out_dtype)
    jp = j_matmul_plan(m, k, n, block_m=bm, block_n=bn, block_k=bk, dtype=jnp.float32,
                       out_dtype=getattr(jnp, str(out_dtype).removeprefix("torch.")))
    assert tp.grid == jp.grid and tp.fingerprint() == jp.fingerprint()
    assert tp.total_flops == jp.total_flops
    for jacc in (jbsp.EPIPHANY_III, jbsp.TPU_V5E_CHIP, jbsp.TPU_V5E_POD):
        assert tp.cost(_pack(jacc)) == jp.cost(jacc)
    assert tp.scratch_bytes == bm * bn * 4     # the accumulator the kernel keeps in registers
    if (m, k, n) == (4096, 4096, 4096):
        assert pipeline.geometry(tp) == ((32, 16, 1), 128)


def test_simt_f32_sweep_refuses_without_a_card(monkeypatch):
    """The tile sweep times kernels: with no CUDA device it raises before
    building anything."""
    from repro_torch.launch import sweep_simt_f32

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.argv", ["sweep_simt_f32"])
    monkeypatch.setattr(pipeline, "sweep_kernels", lambda: pytest.fail("built without a card"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sweep_simt_f32.main()


def _scan_operands(device, grad):
    shapes = [(1, 8, 16), (1, 8, 16), (1, 8, 8), (1, 8, 8), (16, 8), (16,)]
    ts = [torch.ones(s, device=device) for s in shapes]
    ts[-2] = -ts[-2]
    ts[grad].requires_grad_(True)
    return ts


@pytest.mark.parametrize("grad", range(6))   # x, dt, b, c, a, d
def test_ssm_scan_raises_under_autograd_off_the_cpu(grad):
    """An operand that requires grad sends the call through the autograd
    Function (``SelectiveScan``), which makes the wrapper's device check:
    on a device that is neither CUDA nor the CPU (``meta`` here) the call
    raises under grad mode as under no_grad, and never returns an output
    without its graph."""
    args = _scan_operands("meta", grad)
    with pytest.raises(ValueError, match="CUDA or CPU tensors"):
        ssm_scan(*args)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA or CPU tensors"):
        ssm_scan(*args)


def test_ssm_scan_on_the_cpu_keeps_its_graph():
    """On the CPU the plain scan runs under autograd as before."""
    args = _scan_operands("cpu", 0)
    y = ssm_scan(*args)
    y.sum().backward()
    assert y.grad_fn is not None and args[0].grad is not None


def test_reset_clears_the_variant_counts():
    from repro_torch.kernels.streamed_matmul import streamed_matmul

    streamed_matmul.launches_by_variant["wgmma"] += 3
    ops.reset_launch_counts()
    assert ops.matmul_variant_counts() == {"decode": 0, "wgmma": 0, "wgmma_cp": 0,
                                           "decode_cp": 0, "simt_f32": 0, "decode_deep": 0}


def test_cpu_tensors_never_reach_the_library(rng, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the kernel library was touched for a CPU tensor")

    monkeypatch.setattr(pipeline, "library", boom)
    monkeypatch.setattr(pipeline, "launch", boom)
    before, variants = ops.launch_counts(), ops.matmul_variant_counts()
    x = torch.as_tensor(rng.standard_normal((8, 64)), dtype=torch.float32)
    ops.matmul(x, x.T.contiguous())
    ops.dot(x[0], x[1])
    ops.attention(x[None, None], x[None, None], x[None, None])
    s = torch.as_tensor(rng.standard_normal((1, 8, 64)), dtype=torch.float32)
    bc = torch.as_tensor(rng.standard_normal((1, 8, 16)), dtype=torch.float32)
    ops.selective_scan(s, s.abs() * 0.1, bc, bc, -torch.ones(64, 16), torch.ones(64))
    assert ops.launch_counts() == before     # the plain versions launch nothing
    assert ops.matmul_variant_counts() == variants


def test_wrappers_refuse_other_devices():
    x = torch.empty((4, 64), device="meta")
    with pytest.raises(ValueError):
        ops.matmul(x, x.T)
    with pytest.raises(ValueError):
        ops.dot(x[0], x[1])
    with pytest.raises(ValueError):
        ops.attention(x[None, None], x[None, None], x[None, None])
    s, bc = torch.empty((1, 4, 64), device="meta"), torch.empty((1, 4, 16), device="meta")
    a, d = torch.empty((64, 16), device="meta"), torch.empty((64,), device="meta")
    with pytest.raises(ValueError):
        ops.selective_scan(s, s, bc, bc, a, d)


# -- the selective scan --------------------------------------------------------------


def _ssm_inputs(rng, b, seq, di, ds, dtype):
    """The inputs of tests/test_kernels.py's ssm cases, as (jax, torch) pairs."""
    x = rng.standard_normal((b, seq, di)).astype(np.float32)
    dt = np.abs(rng.standard_normal((b, seq, di)).astype(np.float32)) * 0.2
    bb = rng.standard_normal((b, seq, ds)).astype(np.float32)
    c = rng.standard_normal((b, seq, ds)).astype(np.float32)
    a = -np.abs(rng.standard_normal((di, ds)).astype(np.float32)) - 0.1
    d = rng.standard_normal((di,)).astype(np.float32)
    streams = [(jnp.asarray(v, getattr(jnp, dtype)), torch.as_tensor(v).to(getattr(torch, dtype)))
               for v in (x, dt, bb, c)]
    params = [(jnp.asarray(v), torch.as_tensor(v)) for v in (a, d)]
    return [j for j, _ in streams + params], [t for _, t in streams + params]


@pytest.mark.parametrize("seq,chunk", [(64, 16), (100, 32), (128, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_scan_matches_jax_kernel(rng, seq, chunk, dtype):
    jin, tin = _ssm_inputs(rng, 2, seq, 8, 4, dtype)
    got = ops.selective_scan(*tin, chunk=chunk)
    assert got.dtype == tin[0].dtype and got.shape == tin[0].shape
    want = np.asarray(j_ssm(*jin, chunk=chunk, interpret=True), np.float32)
    oracle = np.asarray(jref.ssm_scan_ref(*jin), np.float32)
    if dtype == "float32":
        _close(got, want, TOL[dtype])
        _close(got, oracle, TOL[dtype])
    else:
        tol = 2 * 2 ** -8 * np.abs(oracle).max()
        assert np.abs(got.float().numpy() - want).max() <= tol
        assert np.abs(got.float().numpy() - oracle).max() <= tol


def test_ssm_state_isolation_across_batch(rng):
    """The state resets at each batch row: a row alone gives what it gives
    inside the batch."""
    _, (x, dt, bb, c, _, _) = _ssm_inputs(rng, 3, 32, 4, 2, "float32")
    a, d = -torch.ones((4, 2)), torch.zeros(4)
    full = ops.selective_scan(x, dt * 0.5, bb, c, a, d, chunk=8)
    row = ops.selective_scan(x[1:2], dt[1:2] * 0.5, bb[1:2], c[1:2], a, d, chunk=8)
    torch.testing.assert_close(full[1:2], row, rtol=1e-5, atol=1e-5)


def _pack(acc) -> tbsp.BSPAccelerator:
    return tbsp.BSPAccelerator(**dataclasses.asdict(acc))


SSM_CASES = [(2, 128, 8, 4, 16), (1, 256, 128, 8, 128), (4, 256, 8192, 16, 128)]


@pytest.mark.parametrize("case", SSM_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_plan_parity(case, dtype):
    """The port's ssm_plan is the JAX plan: same grid, tokens, scratch and
    FLOPs, so the same fingerprint and Eq. 1 price on every pack."""
    bsz, seq, di, ds, chunk = case
    tp = ssm_plan(bsz, seq, di, ds, chunk=chunk, dtype=getattr(torch, dtype))
    jp = j_ssm_plan(bsz, seq, di, ds, chunk=chunk, dtype=getattr(jnp, dtype))
    assert tp.grid == jp.grid and tp.dimension_semantics == jp.dimension_semantics
    assert tp.fingerprint() == jp.fingerprint()
    assert tp.fetch_schedule() == jp.fetch_schedule()
    assert tp.writeback_schedule() == jp.writeback_schedule()
    assert tp.vmem_bytes == jp.vmem_bytes and tp.total_flops == jp.total_flops
    for jacc in (jbsp.EPIPHANY_III, jbsp.TPU_V5E_CHIP, jbsp.TPU_V5E_POD):
        assert tp.cost(_pack(jacc)) == jp.cost(jacc)
        assert tp.cost(_pack(jacc), exact=False) == jp.cost(jacc, exact=False)
        assert tp.bandwidth_heavy(_pack(jacc)) == jp.bandwidth_heavy(jacc)


def _fetched_words(plan, names):
    """Words of the named input streams in the plan's fetch walk."""
    total, prev = 0, {}
    for coords in itertools.product(*(range(g) for g in plan.grid)):
        for t in plan.inputs:
            blk = tuple(t.index_map(*coords))
            if t.name in names and blk != prev.get(t.name):
                total += t.words
            prev[t.name] = blk
    return total


def test_ssm_launch_plan_tiles_the_channels():
    """The launch plan makes batch rows and channel tiles parallel and keeps
    the chunk loop: x, Δ and y move the JAX plan's words and the FLOPs are
    the same. Each (row, tile) block reads its rows of A and D once, and
    each tile reads the small B/C chunks of its row. At jamba's forward in
    bf16 the kernel's tile is 64 channels (2 lanes each) and its stage 64
    positions."""
    block_d, stage, seq_p = launch_geometry(256, 128, lanes_for(4, 8192, 16, 132), 2)
    assert (block_d, stage, seq_p) == (64, 64, 256)
    one = ssm_plan(4, 256, 8192, 16, chunk=stage, dtype=torch.bfloat16)
    tiled = ssm_plan(4, 256, 8192, 16, chunk=stage, dtype=torch.bfloat16, block_d=block_d)
    assert pipeline.geometry(tiled) == ((128, 4, 1), 4)
    assert tiled.scratch_bytes == 64 * 16 * 4
    assert tiled.total_flops == one.total_flops
    assert _fetched_words(tiled, ("x", "dt")) == _fetched_words(one, ("x", "dt"))
    assert sum(tiled.writeback_schedule()) == sum(one.writeback_schedule())
    assert _fetched_words(tiled, ("A", "D")) == 4 * _fetched_words(one, ("A", "D"))
    assert _fetched_words(tiled, ("B", "C")) == 128 * _fetched_words(one, ("B", "C"))


@pytest.mark.parametrize("bsz,d_inner,d_state,want", [
    (4, 8192, 16, 2),    # jamba's forward: 2048 warps at 2 lanes, 15.5 an SM
    (1, 8192, 16, 4),    # B 1: 512 warps at 2 lanes would be 3.9 an SM
    (2, 8192, 16, 2),
    (1, 1000, 16, 8),    # too few channels for 6 warps an SM at any grouping
    (1, 1000, 8, 4),     # d_state 8: a lane holds a pair at least, so 4 at most
])
def test_ssm_lanes_rule(bsz, d_inner, d_state, want):
    assert lanes_for(bsz, d_inner, d_state, 132) == want


@pytest.mark.parametrize("bsz,d_inner,d_state,want", [
    # (lanes, block_d, segment, stage): 4 states a lane in a 256-thread
    # block, a checkpoint every 8 positions, two segments a stage, whatever
    # the batch (jamba's train step and B 1 alike: a row alone sums its
    # channels in the order its batch does)
    (4, 8192, 16, (4, 64, 8, 16)),       # jamba: 512 blocks, 1.94 waves at 2 an SM
    (1, 8192, 16, (4, 64, 8, 16)),
    (2, 1000, 16, (4, 64, 8, 16)),
    (1, 200, 8, (2, 128, 8, 16)),        # d_state 8: 2 lanes, 128 channels a block
])
def test_ssm_bwd_lanes_and_segment_rule(bsz, d_inner, d_state, want):
    assert bwd_geometry(d_state) == want


def test_ssm_bwd_geometry_refuses_other_state_widths():
    with pytest.raises(ValueError, match="d_state"):
        bwd_geometry(32)


@pytest.mark.parametrize("seq,chunk,lanes,itemsize,want", [
    (256, 128, 2, 2, (64, 64, 256)),     # bf16: the chunk only sizes the stage, at most 64
    (256, 128, 2, 4, (64, 32, 256)),     # fp32: 32 positions a stage, the same 128 bytes
    (300, 128, 4, 2, (32, 64, 320)),     # ragged L: the plan pads to whole stages
    (7, 128, 4, 2, (32, 7, 7)),          # one short stage
    (4000, 16, 8, 4, (16, 16, 4000)),    # 8 lanes a channel: 16 channels a block
])
def test_ssm_launch_geometry(seq, chunk, lanes, itemsize, want):
    assert launch_geometry(seq, chunk, lanes, itemsize) == want


def test_ssm_launch_geometry_refuses_other_lane_groups():
    with pytest.raises(ValueError):
        launch_geometry(256, 64, 3, 2)
