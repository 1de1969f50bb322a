"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device: the kernels have no CPU mode. They skip
(from the ``cuda`` fixture) where there is none. On the card run
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import HEAD_DIMS, flash_attention
from repro_torch.kernels.ssm_scan import SEGMENT, ssm_scan, ssm_scan_bwd, ssm_scan_with_tape
from repro_torch.kernels.streamed_dot import streamed_dot
from repro_torch.kernels.streamed_matmul import streamed_matmul

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# a machine pack whose 32 MB local memory holds the small decoders' caches: the
# runner verifies each decode plan against it (BSPS141) before it runs
HOST_PACK = dict(p=1, g=0.0, l=1e5, r=1e9, e=0.25, L=(1 << 25) // 4, E=(1 << 34) // 4,
                 word_bytes=4, name="test-host")


def _rand(shape, dtype, device, seed=0):
    g = np.random.default_rng(seed)
    return torch.as_tensor(g.standard_normal(shape), dtype=torch.float32).to(device, dtype)


# bf16 products: fp32 accumulation on both sides, one bf16 rounding of the
# output (relative 2^-8), so the kernel and the plain version differ by at
# most about one output ulp
@pytest.mark.parametrize("m,k,n,variant", [
    (4, 2304, 5760, "decode"), (4, 5760, 2304, "decode"),   # decode MLP (split K)
    (1024, 2304, 5760, "wgmma"),                           # prefill MLP
    (1000, 264, 1032, "wgmma"),                            # ragged m, n and k
    (130, 200, 136, "wgmma"), (17, 8, 8, "wgmma"),         # one partial tile
    (300, 200, 130, "wgmma_cp"), (17, 64, 65, "wgmma_cp"),  # B's rows not 16-byte apart
    (1, 37, 9, "decode_cp"),                               # B's rows 18 bytes apart
    (4, 2304, 5761, "decode_cp"),                          # the same, split K
])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_matmul_kernel_matches_plain(cuda, m, k, n, variant, out_dtype):
    a = _rand((m, k), torch.bfloat16, cuda, 1)
    b = _rand((k, n), torch.bfloat16, cuda, 2) * k ** -0.5
    before = ops.matmul_variant_counts()[variant]
    got = streamed_matmul(a, b, out_dtype=out_dtype)
    want = ref.matmul_ref(a, b, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert ops.matmul_variant_counts()[variant] == before + 1
    tol = 2e-2 if out_dtype == torch.bfloat16 else 1e-3
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


# the decode variant at every decode shape of minicpm-2b and jamba-v0.1-52b
# (MLP up/gate, down and jamba's LM head) at 1 to 16 rows; and a ragged n and k
@pytest.mark.parametrize("m", [1, 4, 8, 16])
@pytest.mark.parametrize("k,n", [(2304, 5760), (5760, 2304), (4096, 14336), (14336, 4096),
                                 (4096, 65536), (1000, 1032)])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_decode_kernel_matches_plain(cuda, m, k, n, out_dtype):
    a = _rand((m, k), torch.bfloat16, cuda, 21)
    b = _rand((k, n), torch.bfloat16, cuda, 22) * k ** -0.5
    before = ops.matmul_variant_counts()["decode"]
    got = streamed_matmul(a, b, out_dtype=out_dtype)
    want = ref.matmul_ref(a, b, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert ops.matmul_variant_counts()["decode"] == before + 1
    tol = 2e-2 if out_dtype == torch.bfloat16 else 1e-3
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("lda", [96, 97])
def test_matmul_kernel_strided_rows(cuda, lda):
    """Row strides of 192 and 194 bytes: the decode variant reads A with
    plain loads, so neither needs TMA's alignment."""
    a = _rand((8, lda), torch.bfloat16, cuda)[:, :64]
    b = _rand((64, 72), torch.bfloat16, cuda, 3)
    before = ops.matmul_variant_counts()["decode"]
    torch.testing.assert_close(streamed_matmul(a, b, out_dtype=torch.float32),
                               ref.matmul_ref(a, b, out_dtype=torch.float32),
                               rtol=1e-3, atol=1e-3)
    assert ops.matmul_variant_counts()["decode"] == before + 1


@pytest.mark.parametrize("m,k,n", [(4, 5760, 2304), (16, 14336, 4096), (4, 2304, 5760)])
def test_decode_cluster_split_is_deterministic(cuda, m, k, n):
    """The cluster's partials are summed in rank order: the same bits every call."""
    a = _rand((m, k), torch.bfloat16, cuda, 23)
    b = _rand((k, n), torch.bfloat16, cuda, 24)
    one = streamed_matmul(a, b, out_dtype=torch.float32)
    assert all(torch.equal(one, streamed_matmul(a, b, out_dtype=torch.float32))
               for _ in range(3))


def test_decode_product_is_one_launch(cuda):
    a = _rand((4, 5760), torch.bfloat16, cuda, 25)
    b = _rand((5760, 2304), torch.bfloat16, cuda, 26)
    ops.reset_launch_counts()
    ops.matmul(a, b)
    assert ops.launch_counts()["streamed_matmul"] == 1
    assert ops.matmul_variant_counts() == {"decode": 1, "wgmma": 0, "wgmma_cp": 0,
                                           "decode_cp": 0, "simt_f32": 0, "decode_deep": 0}


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_wgmma_reads_strided_rows(cuda, out_dtype):
    """A column slice whose rows are 192 bytes apart (a multiple of 16) goes
    through TMA like a contiguous matrix."""
    a = _rand((256, 96), torch.bfloat16, cuda)[:, :64]
    b = _rand((200, 136), torch.bfloat16, cuda, 3)[:64]
    before = ops.matmul_variant_counts()["wgmma"]
    got = streamed_matmul(a, b, out_dtype=out_dtype)
    assert ops.matmul_variant_counts()["wgmma"] == before + 1
    tol = 2e-2 if out_dtype == torch.bfloat16 else 1e-3
    torch.testing.assert_close(got.float(), ref.matmul_ref(a, b, out_dtype=out_dtype).float(),
                               rtol=tol, atol=tol)


def test_wgmma_is_deterministic(cuda):
    a = _rand((1000, 2304), torch.bfloat16, cuda, 16)
    b = _rand((2304, 5768), torch.bfloat16, cuda, 17)
    assert torch.equal(streamed_matmul(a, b), streamed_matmul(a, b))


@pytest.mark.parametrize("n,c", [(1 << 22, 8192), (5000, 512), (100, 128), (8192, 8192)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dot_kernel_matches_plain(cuda, n, c, dtype):
    v, u = _rand((n,), dtype, cuda, 4), _rand((n,), dtype, cuda, 5)
    got = streamed_dot(v, u, token_size=c)
    want = ref.dot_ref(v, u)
    # another summation order over n fp32 products
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3 * n ** 0.5)


def test_dot_kernel_is_deterministic(cuda):
    v, u = _rand((1 << 20,), torch.float32, cuda, 6), _rand((1 << 20,), torch.float32, cuda, 7)
    assert float(streamed_dot(v, u)) == float(streamed_dot(v, u))


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal", [
    (4, 36, 36, 256, 256, 64, True),           # minicpm-2b prefill
    (2, 8, 2, 96, 96, 64, True),               # GQA, ragged
    (2, 4, 1, 1, 128, 128, True),              # decode q_offset
    (1, 4, 4, 32, 96, 64, True),               # queries at the end
    (2, 4, 2, 64, 128, 64, False),             # non-causal
    (1, 2, 2, 70, 70, 128, False),             # non-causal, ragged
    (4, 32, 8, 256, 256, 128, True),           # jamba's forward (GQA 32/8)
    (2, 8, 2, 96, 96, 128, True),              # GQA, ragged, head dim 128
    (2, 4, 1, 1, 128, 64, True),               # decode q_offset, head dim 64
    (1, 4, 4, 100, 300, 128, True),            # ragged queries at the end
    (2, 4, 2, 64, 128, 128, False),            # non-causal, head dim 128
    (1, 2, 2, 70, 70, 64, False),              # non-causal, ragged, head dim 64
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(cuda, b, hq, hkv, sq, skv, d, causal, dtype):
    q = _rand((b, hq, sq, d), dtype, cuda, 8)
    k = _rand((b, hkv, skv, d), dtype, cuda, 9)
    v = _rand((b, hkv, skv, d), dtype, cuda, 10)
    got = flash_attention(q, k, v, causal=causal)
    want = ref.attention_ref(q, k, v, causal=causal)
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("d", [64, 128, 192])
def test_flash_bf16_is_deterministic(cuda, d):
    q = _rand((2, 8, 200, d), torch.bfloat16, cuda, 18)
    k = _rand((2, 2, 200, d), torch.bfloat16, cuda, 19)
    v = _rand((2, 2, 200, d), torch.bfloat16, cuda, 20)
    assert torch.equal(flash_attention(q, k, v), flash_attention(q, k, v))


def test_flash_bf16_refuses_unaligned_rows(cuda):
    x = _rand((1, 2, 64 * 64 + 1), torch.bfloat16, cuda)[..., 1:].reshape(1, 2, 64, 64)
    with pytest.raises(ValueError, match="16 bytes"):
        flash_attention(x, x, x)


def test_flash_kernel_reads_strided_heads(cuda):
    x = _rand((2, 64, 3, 4, 64), torch.bfloat16, cuda, 11)   # (B, S, qkv, H, D)
    q, k, v = (x[:, :, i].transpose(1, 2) for i in range(3))
    torch.testing.assert_close(flash_attention(q, k, v).float(),
                               ref.attention_ref(q, k, v).float(), rtol=2e-2, atol=2e-2)


def test_wrappers_count_their_launches(cuda):
    ops.reset_launch_counts()
    a = _rand((4, 64), torch.bfloat16, cuda)
    ops.matmul(a, a.T.contiguous())
    ops.dot(a[0].float(), a[1].float())
    q = _rand((1, 2, 64, 64), torch.bfloat16, cuda)
    ops.attention(q, q, q)
    x = _rand((1, 8, 128), torch.bfloat16, cuda)
    bc = _rand((1, 8, 16), torch.bfloat16, cuda)
    ops.selective_scan(x, x.abs(), bc, bc, -torch.ones((128, 16), device=cuda),
                       torch.ones(128, device=cuda))
    assert ops.launch_counts() == {"streamed_dot": 1, "streamed_matmul": 1,
                                   "flash_attention": 1, "flash_attention_bwd": 0,
                                   "ssm_scan": 1, "ssm_scan_bwd": 0}


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    with pytest.raises(TypeError):
        streamed_matmul(torch.ones(4, 4, device=cuda).half(), torch.ones(4, 4, device=cuda).half())
    with pytest.raises(TypeError):      # fp32 and bf16 operands mixed
        streamed_matmul(torch.ones(4, 4, device=cuda), torch.ones(4, 4, device=cuda).bfloat16())
    q = torch.ones(1, 1, 8, 320, device=cuda)  # head dims above 256 are refused
    with pytest.raises(ValueError):
        flash_attention(q, q, q)
    x, a, d = (torch.ones(1, 8, 64, device=cuda), -torch.ones(64, 32, device=cuda),
               torch.ones(64, device=cuda))
    bc = torch.ones(1, 8, 32, device=cuda)
    with pytest.raises(ValueError, match="d_state"):
        ssm_scan(x, x, bc, bc, a, d)                         # d_state 32
    with pytest.raises(TypeError):
        ssm_scan(x, x, bc[..., :16].contiguous(), bc[..., :16].contiguous(),
                 a[:, :16].contiguous().half(), d)           # A not fp32


@pytest.mark.parametrize("compiled", [False, True])
def test_runner_stages_tokens_on_the_card(cuda, compiled):
    """The §3.1 inner product through the runner on the card: the DMA lane
    stages tokens through pinned memory (measure mode) or the whole streams
    once (compiled mode), and ops.dot launches the kernel in the step."""
    from repro_torch.core.hyperstep import HyperstepRunner
    from repro_torch.core.stream import StreamSet

    g = np.random.default_rng(12)
    v = g.standard_normal(1 << 16).astype(np.float32)
    u = g.standard_normal(1 << 16).astype(np.float32)
    ss = StreamSet()
    sv, su = ss.create(v, 1 << 12), ss.create(u, 1 << 12)
    before = ops.launch_counts()["streamed_dot"]
    runner = HyperstepRunner(lambda acc, t: acc + ops.dot(t[0], t[1]), [sv, su])
    got = float(runner.run(torch.zeros((), device=cuda), compiled=compiled))
    assert got == pytest.approx(float(np.dot(v.astype(np.float64), u)), rel=1e-5, abs=1e-2)
    assert ops.launch_counts()["streamed_dot"] - before == 16


def test_generate_modes_agree_on_the_card(cuda):
    """A 2-layer, head-dim-64 decoder in bf16 on the card: compiled and
    measure-mode greedy decoding give the same tokens through the kernels."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.bsp import BSPAccelerator
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as M

    cfg = dataclasses.replace(get_config("minicpm-2b", smoke=True), d_model=256,
                              d_ff=512, num_heads=4, num_kv_heads=4, dtype="bfloat16")
    params = M.init_params(cfg, 0, device=cuda)
    prompt = torch.randint(0, cfg.vocab_size, (2, 70), generator=torch.Generator().manual_seed(0))
    before = ops.launch_counts()["streamed_matmul"]
    pack = BSPAccelerator(**HOST_PACK)
    a, sa = generate(cfg, params, prompt, steps=5, machine=pack, device=cuda)
    b, sb = generate(cfg, params, prompt, steps=5, machine=pack, device=cuda,
                     compiled=False)
    assert torch.equal(a, b) and tuple(a.shape) == (2, 75)
    assert ops.launch_counts()["streamed_matmul"] > before
    assert sa.plan_row["fetch_words_planned"] == sa.plan_row["fetch_words_measured"]


def _ssm_inputs(b, seq, di, ds, dtype, device, seed):
    g = np.random.default_rng(seed)
    x = torch.as_tensor(g.standard_normal((b, seq, di)), dtype=torch.float32)
    dt = torch.as_tensor(np.abs(g.standard_normal((b, seq, di))) * 0.05, dtype=torch.float32)
    bb = torch.as_tensor(g.standard_normal((b, seq, ds)), dtype=torch.float32)
    c = torch.as_tensor(g.standard_normal((b, seq, ds)), dtype=torch.float32)
    a = -torch.arange(1, ds + 1, dtype=torch.float32).expand(di, ds).contiguous()
    d = torch.as_tensor(g.standard_normal(di), dtype=torch.float32)
    return ([t.to(device, dtype) for t in (x, dt, bb, c)]
            + [a.to(device), d.to(device)])


# the scan in fp32 on both sides: sums in another order and an fma, a few
# ulps of the state over the sequence; bf16 streams: the same fp32 scan from
# the same bf16 inputs, one bf16 rounding of the output on each side (two
# ulps of the largest output)
@pytest.mark.parametrize("b,seq,di,ds,chunk", [
    (4, 256, 8192, 16, 128),       # jamba's forward
    (1, 300, 200, 8, 64),          # ragged L and ragged d_inner
    (2, 100, 130, 16, 32),         # ragged both, short chunk
    (3, 7, 128, 8, 128),           # one short chunk
    (1, 4000, 256, 16, 128),       # long, ragged last chunk
    (1, 4000, 8192, 16, 128),      # B 1 at jamba's full width
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_kernel_matches_plain(cuda, b, seq, di, ds, chunk, dtype):
    x, dt, bb, c, a, d = _ssm_inputs(b, seq, di, ds, dtype, cuda, 13)
    got = ssm_scan(x, dt, bb, c, a, d, chunk=chunk)
    want = ref.ssm_scan_ref(x, dt, bb, c, a, d)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == x.shape
    tol = 1e-4 if dtype == torch.float32 else 2 * 2 ** -8
    scale = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= tol * scale


@pytest.mark.parametrize("b,seq,di,ds,lanes", [
    (2, 100, 130, 16, 2), (2, 100, 130, 16, 4), (2, 100, 130, 16, 8),
    (1, 300, 200, 8, 2), (1, 300, 200, 8, 4),          # d_state 8: a pair a lane at least
    (1, 200, 8192, 16, 2), (1, 200, 8192, 16, 4), (1, 200, 8192, 16, 8),   # B 1, full width
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_lane_groups_match_plain(cuda, b, seq, di, ds, lanes, dtype):
    """Each channel's states split over 2, 4 or 8 lanes, at d_state 8 and 16
    (tolerances as above), and every grouping gives the same bits."""
    x, dt, bb, c, a, d = _ssm_inputs(b, seq, di, ds, dtype, cuda, 16)
    got = ssm_scan(x, dt, bb, c, a, d, lanes=lanes)
    want = ref.ssm_scan_ref(x, dt, bb, c, a, d)
    tol = 1e-4 if dtype == torch.float32 else 2 * 2 ** -8
    scale = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= tol * scale
    assert torch.equal(got, ssm_scan(x, dt, bb, c, a, d, lanes=2))


def test_ssm_refuses_lane_groups_past_the_states(cuda):
    x, dt, bb, c, a, d = _ssm_inputs(1, 16, 64, 8, torch.float32, cuda, 17)
    with pytest.raises(ValueError, match="lanes"):
        ssm_scan(x, dt, bb, c, a, d, lanes=8)


def test_ssm_kernel_isolates_batch_rows(cuda):
    x, dt, bb, c, a, d = _ssm_inputs(3, 200, 300, 16, torch.float32, cuda, 14)
    full = ssm_scan(x, dt, bb, c, a, d, chunk=64)
    row = ssm_scan(x[1:2].contiguous(), dt[1:2].contiguous(), bb[1:2].contiguous(),
                   c[1:2].contiguous(), a, d, chunk=64)
    assert torch.equal(full[1:2], row)


def test_ssm_row_alone_matches_batch_at_full_width(cuda):
    """At jamba's width a batch of 4 takes 2 lanes a channel and one row
    alone 4 (ssm_scan.lanes_for): the same bits all the same."""
    x, dt, bb, c, a, d = _ssm_inputs(4, 100, 8192, 16, torch.bfloat16, cuda, 18)
    full = ssm_scan(x, dt, bb, c, a, d)
    row = ssm_scan(*(t[2:3].contiguous() for t in (x, dt, bb, c)), a, d)
    assert torch.equal(full[2:3], row)


def test_ssm_kernel_is_deterministic_and_chunk_free(cuda):
    x, dt, bb, c, a, d = _ssm_inputs(2, 333, 256, 16, torch.bfloat16, cuda, 15)
    one = ssm_scan(x, dt, bb, c, a, d, chunk=128)
    assert torch.equal(one, ssm_scan(x, dt, bb, c, a, d, chunk=128))
    # the chunk only sizes the stage: the same recurrence, the same bits
    assert torch.equal(one, ssm_scan(x, dt, bb, c, a, d, chunk=16))


def test_hybrid_serve_on_the_card(cuda):
    """A one-period jamba stack at head dim 64 (the flash kernel's) in bf16 on
    the card: compiled and measure-mode greedy decoding agree, the forward
    launches the scan kernel once per Mamba layer, and its last logits
    follow the token-at-a-time prefill's."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.bsp import BSPAccelerator
    from repro_torch.launch.serve import generate, make_prefill
    from repro_torch.models import model as M
    from repro_torch.train.steps import make_prefill_step

    cfg = dataclasses.replace(get_config("jamba-v0.1-52b", smoke=True), d_model=256,
                              num_heads=4, num_kv_heads=2, d_ff=512, moe_d_ff=512,
                              ssm_d_state=16, moe_capacity_factor=8.0, dtype="bfloat16")
    params = M.init_params(cfg, 0, device=cuda)
    prompt = torch.randint(0, cfg.vocab_size, (2, 40), generator=torch.Generator().manual_seed(0))
    pack = BSPAccelerator(**HOST_PACK)
    a, sa = generate(cfg, params, prompt, steps=5, machine=pack, device=cuda)
    b, _ = generate(cfg, params, prompt, steps=5, machine=pack, device=cuda,
                    compiled=False)
    assert torch.equal(a, b) and tuple(a.shape) == (2, 45)
    assert sa.plan_row["fetch_words_planned"] == sa.plan_row["fetch_words_measured"]
    before = ops.launch_counts()
    logits = make_prefill_step(cfg, device=cuda)(params, {"tokens": prompt.to(cuda)})
    counts = {k: v - before[k] for k, v in ops.launch_counts().items()}
    assert counts["ssm_scan"] == 7 and counts["flash_attention"] == 1
    assert counts["streamed_matmul"] > 0
    pre, _ = make_prefill(cfg, 1, device=cuda)(params, M.init_cache(cfg, 2, 40, device=cuda),
                                               prompt.to(cuda))
    last, pre = logits[:, -1].float(), pre[:, -1].float()
    assert (last - pre).abs().max() <= 0.05 * pre.abs().max()


# -- the continuous-batching engine at a 2-layer full-width cut of minicpm-2b --------

# A packed lane (m = 8 rows in each product) and the same request alone
# (m = 1) round differently in the plain products. chip_smoke.py's rule: fed
# the engine's tokens, a batch-1 decode's logits stay within NEAR_TIE / 2 of
# the lane's at every segment boundary (relative to the largest |logit|), and
# every engine token's batch-1 logit is within NEAR_TIE of the top one.
NEAR_TIE = 2.0 ** -4


@pytest.fixture(scope="module")
def engine_cut():
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    cfg = dataclasses.replace(get_config("minicpm-2b"), num_layers=2)    # bf16, full width
    return cfg, M.init_params(cfg, 0, device="cuda")


def _engine(cfg, params, **kw):
    from repro_torch.core.bsp import BSPAccelerator
    from repro_torch.launch.engine import ServeEngine

    return ServeEngine(cfg, params, max_lanes=8, pool_seq=128, segment_len=4,
                       machine=BSPAccelerator(**HOST_PACK), calibstore=False,
                       device="cuda", **kw)


def _requests(cfg, seed=4):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.vocab_size, s).astype(np.int32), n)
            for s, n in ((20, 12), (37, 8), (64, 12), (90, 16), (9, 12))]


def test_engine_packed_lanes_match_batch1_on_the_card(cuda, engine_cut):
    from repro_torch.core.bsp import BSPAccelerator
    from repro_torch.launch.serve import generate, make_prefill, prefill_block_size
    from repro_torch.models import model as M

    cfg, params = engine_cut
    pack = BSPAccelerator(**HOST_PACK)
    reqs = _requests(cfg)
    eng = _engine(cfg, params)
    before = ops.matmul_variant_counts()
    rids = [eng.submit(p, n) for p, n in reqs]
    seen = {rid: [] for rid in rids}
    while eng.queue or eng.running:
        eng.step_segment()
        for rid, req in eng.running.items():
            seen[rid].append((len(req.generated), eng._logits[req.lane, -1].clone()))
    out = eng.run_until_drained()
    counts = {k: v - before[k] for k, v in ops.matmul_variant_counts().items()}
    assert counts["decode"] > 0 and counts["wgmma"] > 0      # packed steps; joins' prefills
    for rid, (p, n) in zip(rids, reqs):
        prompt = torch.from_numpy(p).cuda()
        got = out[rid][len(p):].tolist()
        block = prefill_block_size(cfg, 1, len(p), pack)
        logits, cache = make_prefill(cfg, block, device="cuda")(
            params, M.init_cache(cfg, 1, eng.pool_seq, device="cuda"), prompt[None])
        lg1 = []
        for tok in got:                    # teacher-forced on the engine's tokens
            lg1.append(logits[0, -1].float())
            logits, cache = M.decode_step(cfg, params, cache,
                                          torch.tensor([[tok]], dtype=torch.int32,
                                                       device="cuda"), device="cuda")
        lg1 = torch.stack(lg1)
        scale = lg1.abs().amax(-1)
        want = torch.argmax(lg1, -1).tolist()
        div = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
        # the first token comes from the same batch-1 prefill in both runs
        assert div != 0, rid
        upto = n if div is None else div + 1
        seq, _ = generate(cfg, params, prompt[None], steps=n, machine=pack,
                          max_len=eng.pool_seq, device="cuda")
        assert seq[0, len(p):len(p) + upto].tolist() == want[:upto]
        assert seen[rid], rid
        for at, lg in seen[rid]:
            assert got[at] == int(torch.argmax(lg)), (rid, at)
            assert (lg - lg1[at]).abs().max() < NEAR_TIE / 2 * scale[at], (rid, at)
        fed = torch.tensor(got, device="cuda")
        gaps = (lg1.amax(-1) - lg1.gather(1, fed[:, None])[:, 0]) / scale
        assert float(gaps.max()) <= NEAR_TIE, (rid, gaps.tolist())


def test_engine_sampled_run_repeats_under_its_seed_on_the_card(cuda, engine_cut):
    cfg, params = engine_cut
    outs = []
    for _ in range(2):
        eng = _engine(cfg, params, temperature=1.0)
        rids = [eng.submit(p, n, seed=10 + i) for i, (p, n) in enumerate(_requests(cfg))]
        out = eng.run_until_drained()
        outs.append([out[r].tolist() for r in rids])
    assert outs[0] == outs[1]


def test_engine_segment_makes_no_host_sync_on_the_card(cuda, engine_cut):
    """From the second segment on, the compiled replay runs under
    ``torch.cuda.set_sync_debug_mode("error")``: a host sync inside a
    segment raises."""
    cfg, params = engine_cut
    eng = _engine(cfg, params)
    prog = eng._runner._compiled_cache[eng.segment_len]
    inner, calls = prog._call, []

    def guarded(*args):
        if calls:
            torch.cuda.set_sync_debug_mode("error")
        try:
            return inner(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
            calls.append(1)

    prog._call = guarded
    for p, n in _requests(cfg):
        eng.submit(p, n)
    eng.run_until_drained()
    assert len(calls) == eng.stats()["segments"] >= 3


# -- operand layouts, the flash lse and the backward passes ---------------------------


def _plain(a, b, out_dtype, a_layout="mk", b_layout="kn"):
    return ref.matmul_ref(a, b, out_dtype=out_dtype, a_layout=a_layout, b_layout=b_layout)


# B given as its (n, k) transpose: the decode variant (weights by TMA boxes
# over rows of k, ldmatrix untransposed) and wgmma (the K-major operand), at
# minicpm-2b's tied head (n = 122753: an odd output row stride), a ragged odd
# n, and the input gradients of an MLP product
@pytest.mark.parametrize("m,k,n,variant", [
    (1, 2304, 122753, "decode"), (8, 2304, 122753, "decode"), (16, 1000, 1033, "decode"),
    (4, 5760, 2304, "decode"),
    (1024, 2304, 122753, "wgmma"), (300, 264, 1033, "wgmma"), (1024, 5760, 2304, "wgmma"),
    (17, 64, 8, "wgmma"),
])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_matmul_nk_layout_matches_plain(cuda, m, k, n, variant, out_dtype):
    a = _rand((m, k), torch.bfloat16, cuda, 31)
    b = _rand((n, k), torch.bfloat16, cuda, 32) * k ** -0.5
    before = ops.matmul_variant_counts()[variant]
    got = streamed_matmul(a, b, out_dtype=out_dtype, b_layout="nk")
    want = _plain(a, b, out_dtype, b_layout="nk")
    torch.cuda.synchronize()
    assert ops.matmul_variant_counts()[variant] == before + 1
    assert got.shape == (m, n) and got.stride() == (n, 1)
    tol = 2e-2 if out_dtype == torch.bfloat16 else 1e-3
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


# A given as its (k, m) transpose (the weight gradient Aᵀ·dC): wgmma's
# M-major operand, at an MLP product's dW shapes and ragged m, n and k
@pytest.mark.parametrize("m,k,n", [(2304, 1024, 5760), (5760, 1024, 2304), (1000, 264, 136),
                                   (16, 64, 128)])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_matmul_km_layout_matches_plain(cuda, m, k, n, out_dtype):
    a = _rand((k, m), torch.bfloat16, cuda, 33)
    b = _rand((k, n), torch.bfloat16, cuda, 34) * k ** -0.5
    before = ops.matmul_variant_counts()["wgmma"]
    got = streamed_matmul(a, b, out_dtype=out_dtype, a_layout="km")
    want = _plain(a, b, out_dtype, a_layout="km")
    torch.cuda.synchronize()
    assert ops.matmul_variant_counts()["wgmma"] == before + 1
    tol = 2e-2 if out_dtype == torch.bfloat16 else 1e-3
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_matmul_layouts_need_tma(cuda):
    """A transposed operand that TMA cannot describe (rows 134 or 74 bytes
    apart) is staged into an aligned copy and runs on the TMA variant
    (``decode`` for the (n, k) B at 8 rows, ``wgmma`` for the (k, m) A),
    one launch each, matching the plain version; nothing falls back to a
    variant that reads the default layout."""
    cases = [(_rand((8, 64), torch.bfloat16, cuda, 37),
              _rand((9, 67), torch.bfloat16, cuda, 38)[:, :64], "mk", "nk", "decode"),
             (_rand((64, 37), torch.bfloat16, cuda, 39),
              _rand((64, 64), torch.bfloat16, cuda, 40) * 0.125, "km", "kn", "wgmma")]
    for a, b, a_layout, b_layout, variant in cases:
        before = ops.matmul_variant_counts()
        got = streamed_matmul(a, b, a_layout=a_layout, b_layout=b_layout)
        want = _plain(a, b, torch.bfloat16, a_layout=a_layout, b_layout=b_layout)
        torch.cuda.synchronize()
        after = ops.matmul_variant_counts()
        assert {v: after[v] - before[v] for v in after if after[v] != before[v]} == {variant: 1}
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


# the tied head (n = 122753) is (n, k) only: a (k, n) copy has an odd row stride
@pytest.mark.parametrize("b_layout,k,n", [
    (layout, k, n) for layout in ("kn", "nk")
    for k, n in ((2304, 2304), (2304, 5760), (5760, 2304))] + [("nk", 2304, 122753)])
def test_decode_rows_are_batch_invariant(cuda, b_layout, k, n):
    """Rows 1..8 take one K split and one kernel instance: a row alone gives
    the bits it gives among 8 (a packed decode lane against batch 1)."""
    a = _rand((8, k), torch.bfloat16, cuda, 35)
    b = _rand((k, n) if b_layout == "kn" else (n, k), torch.bfloat16, cuda, 36) * k ** -0.5
    full = streamed_matmul(a, b, b_layout=b_layout)
    for i in (0, 3, 7):
        assert torch.equal(streamed_matmul(a[i:i + 1], b, b_layout=b_layout), full[i:i + 1])
    assert torch.equal(streamed_matmul(a[:4], b, b_layout=b_layout), full[:4])


@pytest.mark.parametrize("hq,hkv,d,skv", [(36, 36, 64, 512), (32, 8, 128, 20000)])
def test_cache_read_lanes_are_batch_invariant(cuda, hq, hkv, d, skv):
    """The single-token cache read, over one chunk of positions (minicpm's
    heads) and over three, the last partial (jamba's): a lane read alone at
    its own length gives the bits it gives among 8 lanes at mixed lengths."""
    from repro_torch.models.attention import dense_cache_attention

    q = _rand((8, hq, 1, d), torch.bfloat16, cuda, 40)
    # the cache as decode stores it, (B, S, Hkv, D), read as (B, Hkv, S, D)
    k = _rand((8, skv, hkv, d), torch.bfloat16, cuda, 41).transpose(1, 2)
    v = _rand((8, skv, hkv, d), torch.bfloat16, cuda, 42).transpose(1, 2)
    lens = torch.tensor([skv, 3, skv // 2, 1, skv - 7, 100, 17, skv], device=cuda)
    full = dense_cache_attention(q, k, v, kv_valid_len=lens)
    for i in (0, 2, 4, 7):
        alone = dense_cache_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                      kv_valid_len=int(lens[i]))
        assert torch.equal(alone, full[i:i + 1])


@pytest.mark.parametrize("b_layout", ["kn", "nk"])
@pytest.mark.parametrize("m,k,n", [(1024, 2304, 5760), (1024, 2304, 1033), (8, 2304, 5760)])
def test_matmul_function_grads_on_the_card(cuda, b_layout, m, k, n):
    """The Function's backward on the kernel (dA with B in the other layout,
    dB with A or dC read as a (k, m) transpose; an odd n copied to padded
    rows) against fp32 CPU autograd through the plain version: bf16 inputs
    and outputs, fp32 sums, bounded at 2% of the largest gradient."""
    a = _rand((m, k), torch.bfloat16, cuda, 37).requires_grad_(True)
    b = (_rand((k, n) if b_layout == "kn" else (n, k), torch.bfloat16, cuda, 38)
         * k ** -0.5).requires_grad_(True)
    dc = _rand((m, n), torch.bfloat16, cuda, 39)
    before = ops.launch_counts()["streamed_matmul"]
    out = ops.Matmul.apply(a, b, b_layout, torch.bfloat16)
    da, db = torch.autograd.grad(out, (a, b), dc)
    assert ops.launch_counts()["streamed_matmul"] == before + 3
    ca, cb = (t.detach().float().cpu().requires_grad_(True) for t in (a, b))
    cout = ops.Matmul.apply(ca, cb, b_layout, torch.float32)
    wa, wb = torch.autograd.grad(cout, (ca, cb), dc.float().cpu())
    for got, want in ((out, cout), (da, wa), (db, wb)):
        assert got.dtype == torch.bfloat16
        err = (got.float().cpu() - want).abs().max()
        assert err <= 0.02 * want.abs().max(), err


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal", [
    (4, 36, 36, 256, 256, 64, True),           # minicpm-2b
    (4, 32, 8, 256, 256, 128, True),           # jamba (GQA 32/8)
    (2, 8, 2, 100, 100, 64, True),             # GQA, ragged
    (1, 4, 4, 100, 300, 128, True),            # ragged queries at the end
    (2, 4, 2, 70, 70, 64, False),              # non-causal, ragged
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_lse_matches_plain(cuda, b, hq, hkv, sq, skv, d, causal, dtype):
    """The rows' log-sum-exp: the bf16 kernel's from its log2-domain state,
    the fp32 kernel's natural; fp32 sums on both sides, 1e-3 absolute (the
    scores are O(1))."""
    q = _rand((b, hq, sq, d), dtype, cuda, 40)
    k = _rand((b, hkv, skv, d), dtype, cuda, 41)
    v = _rand((b, hkv, skv, d), dtype, cuda, 42)
    out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    want_out, want = ref.attention_ref_lse(q, k, v, causal=causal)
    assert lse.shape == (b, hq, sq) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, want, rtol=0, atol=1e-3)
    assert torch.equal(out, flash_attention(q, k, v, causal=causal))


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal", [
    (2, 36, 36, 256, 256, 64, True),            # minicpm-2b
    (2, 32, 8, 256, 256, 128, True),            # jamba (GQA 32/8)
    (1, 8, 2, 100, 100, 64, True),              # GQA, ragged
    (1, 96, 8, 256, 256, 192, True),            # nemotron
    (2, 4, 2, 128, 128, 16, True), (2, 4, 2, 128, 128, 32, True),   # quickstart's, D 32
    (1, 16, 8, 256, 256, 256, True),            # D 256
    (2, 4, 2, 70, 70, 64, False),               # non-causal, ragged
    (1, 4, 4, 100, 300, 128, True),             # Sq < Skv, queries at the end of the keys
    (1, 8, 2, 77, 200, 256, False),             # the same, non-causal, split columns
    (1, 4, 2, 131, 131, 32, True),              # S not a multiple of any tile
])
def test_flash_function_grads_on_the_card(cuda, b, hq, hkv, sq, skv, d, causal):
    """FlashAttention's (dq, dk, dv): the kernel forward and the backward
    kernel on bf16 card tensors (one ``flash_attention_bwd`` count a
    backward), against fp32 CPU autograd through the plain version; bounded
    at 2% of the largest gradient (bf16 inputs, P rounded to bf16 in the
    forward, P and dS in the backward)."""
    from repro_torch.models.flash import FlashAttention

    qkv = [_rand(shape, torch.bfloat16, cuda, 43 + i).requires_grad_(True)
           for i, shape in enumerate(((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))]
    do = _rand((b, hq, sq, d), torch.bfloat16, cuda, 46)
    before = ops.launch_counts()
    got = torch.autograd.grad(FlashAttention.apply(*qkv, causal), qkv, do)
    after = ops.launch_counts()
    assert after["flash_attention"] == before["flash_attention"] + 1
    assert after["flash_attention_bwd"] == before["flash_attention_bwd"] + 1
    cpu = [t.detach().float().cpu().requires_grad_(True) for t in qkv]
    want = torch.autograd.grad(FlashAttention.apply(*cpu, causal), cpu, do.float().cpu())
    for g, w, t in zip(got, want, qkv):
        assert g.dtype == torch.bfloat16 and g.shape == t.shape
        assert (g.float().cpu() - w).abs().max() <= 0.02 * w.abs().max()


@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_bwd_is_deterministic(cuda, d):
    """Two backwards of the same inputs give the same bits: no atomics, every
    sum in a fixed order."""
    from repro_torch.models.flash import FlashAttention

    qkv = [_rand(shape, torch.bfloat16, cuda, 50 + i).requires_grad_(True)
           for i, shape in enumerate(((2, 8, 300, d), (2, 2, 300, d), (2, 2, 300, d)))]
    do = _rand((2, 8, 300, d), torch.bfloat16, cuda, 53)
    first = torch.autograd.grad(FlashAttention.apply(*qkv, True), qkv, do)
    second = torch.autograd.grad(FlashAttention.apply(*qkv, True), qkv, do)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("d", [64, 128])
def test_flash_bwd_rows_are_batch_invariant(cuda, d):
    """A batch row's (dq, dk, dv) are the same bits alone (batch 1) as in a
    batch of 4: no block's work depends on the other rows."""
    from repro_torch.models.flash import FlashAttention

    shapes = ((4, 8, 200, d), (4, 2, 200, d), (4, 2, 200, d))
    qkv = [_rand(shape, torch.bfloat16, cuda, 60 + i) for i, shape in enumerate(shapes)]
    do = _rand((4, 8, 200, d), torch.bfloat16, cuda, 63)

    def grads(rows):
        x = [t[rows].clone().requires_grad_(True) for t in qkv]
        return torch.autograd.grad(FlashAttention.apply(*x, True), x, do[rows].clone())

    batch = grads(slice(0, 4))
    for i in (0, 3):
        alone = grads(slice(i, i + 1))
        assert all(torch.equal(a, b[i:i + 1]) for a, b in zip(alone, batch))


def test_flash_fp32_backward_keeps_the_torch_ops(cuda):
    """fp32 card tensors keep the torch-op backward (exact fp32 products, as
    the fp32 forward keeps them): no ``flash_attention_bwd`` count, the
    gradients within 1e-4 of fp32 CPU autograd through the plain version."""
    from repro_torch.models.flash import FlashAttention

    qkv = [_rand(shape, torch.float32, cuda, 70 + i).requires_grad_(True)
           for i, shape in enumerate(((1, 4, 96, 64), (1, 2, 96, 64), (1, 2, 96, 64)))]
    do = _rand((1, 4, 96, 64), torch.float32, cuda, 73)
    before = ops.launch_counts()["flash_attention_bwd"]
    got = torch.autograd.grad(FlashAttention.apply(*qkv, True), qkv, do)
    assert ops.launch_counts()["flash_attention_bwd"] == before
    cpu = [t.detach().cpu().requires_grad_(True) for t in qkv]
    want = torch.autograd.grad(ref.attention_ref(*cpu, causal=True), cpu, do.cpu())
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4)


def test_packed_lane_logits_equal_batch1_bitwise(cuda, engine_cut):
    """A decode step at m = 8 (lanes at mixed positions) and the same lane
    alone at m = 1 give the same logits bit for bit: every product on the
    decode kernel with one K split, the norms and the cache reads with
    reductions whose shape does not follow the batch."""
    from repro_torch.models import model as M

    cfg, params = engine_cut
    rng = np.random.default_rng(5)
    lens = [30, 7, 64, 1, 99, 12, 45, 80]
    cache = M.init_cache(cfg, 8, 128, device="cuda")
    for per in cache["layers"]:
        for layer in per:
            for key in ("k", "v"):
                layer[key].copy_(_rand(tuple(layer[key].shape), torch.bfloat16, cuda, 47))
    cache["len"] = torch.tensor(lens, device=cuda)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (8, 1)), dtype=torch.int32,
                           device=cuda)
    alone = []
    for i in range(8):
        one = M.init_cache(cfg, 1, 128, device="cuda")
        for per, per1 in zip(cache["layers"], one["layers"]):
            for layer, layer1 in zip(per, per1):
                for key in ("k", "v"):
                    layer1[key].copy_(layer[key][i:i + 1])
        one["len"] = lens[i]
        alone.append(M.decode_step(cfg, params, one, toks[i:i + 1], device="cuda")[0])
    packed, _ = M.decode_step(cfg, params, cache, toks, device="cuda")
    for i in range(8):
        assert torch.equal(packed[i:i + 1], alone[i]), (
            i, float((packed[i:i + 1].float() - alone[i].float()).abs().max()))


def test_train_step_on_the_card_matches_cpu(cuda):
    """One bf16 train step of a 2-layer full-width minicpm-2b cut on the
    card (every product, forward and backward, on the matmul kernel; the
    flash kernel forward) against the same step in fp32 on the CPU through
    the plain versions: the loss within 2%, the gradient norm within 5%,
    and every parameter moved."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import AdamW, leaves
    from repro_torch.optim.compress import tree_map
    from repro_torch.optim.schedule import constant
    from repro_torch.train.steps import make_train_step

    cfg = dataclasses.replace(get_config("minicpm-2b"), num_layers=2, remat="none")
    params = M.init_params(cfg, 0, device="cuda")
    cpu = tree_map(lambda t: t.float().cpu(), params)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab_size, (2, 129))
    batch = {"tokens": torch.as_tensor(toks[:, :-1]), "labels": torch.as_tensor(toks[:, 1:])}
    # bf16 parameters move only by more than half an ulp: at 3e-3 the norm
    # scales (1.0, an ulp of 2^-8 below) move too
    opt = AdamW(constant(3e-3))
    before = [p.clone() for p in leaves(params)]
    ops.reset_launch_counts()
    _, _, got = make_train_step(cfg, opt, device="cuda")(
        params, opt.init(params), {k: v.cuda() for k, v in batch.items()})
    counts = ops.launch_counts()
    assert counts["streamed_matmul"] == 3 * (7 * cfg.num_layers + 1)
    assert counts["flash_attention"] == cfg.num_layers
    assert counts["flash_attention_bwd"] == cfg.num_layers
    _, _, want = make_train_step(dataclasses.replace(cfg, dtype="float32"), opt,
                                 device="cpu")(cpu, opt.init(cpu), batch)
    assert abs(float(got["loss"]) - float(want["loss"])) <= 0.02 * float(want["loss"])
    assert abs(float(got["grad_norm"]) - float(want["grad_norm"])) <= 0.05 * float(
        want["grad_norm"])
    assert all(not torch.equal(a, b) for a, b in zip(before, leaves(params)))


# fp32 operands: exact fp32 FMAs on both sides (TF32 off in the fixture),
# sums in another order; bounded at 1e-5 of the largest output, about
# 50 times the typical sqrt(k)·2^-24 relative spread at k = 4096
@pytest.mark.parametrize("m,k,n", [
    (1, 64, 64), (4, 2304, 5760), (16, 37, 9),           # m ≤ 16
    (300, 200, 130), (1000, 264, 1031), (129, 8, 127),   # ragged m, n and k edges
    (4096, 4096, 4096),                                  # Cannon's local product
    # the ring (K steps of 32, 3 stages): k below one stage, between one
    # stage and the full ring, past it and no multiple of 32, and k = 1;
    # m and n one past a 256 × 128 tile
    (64, 5, 96), (130, 40, 200), (200, 1000, 300), (33, 1, 65), (257, 64, 129),
])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_fp32_matmul_kernel_matches_plain(cuda, m, k, n, out_dtype):
    a = _rand((m, k), torch.float32, cuda, 31)
    b = _rand((k, n), torch.float32, cuda, 32)
    before = ops.matmul_variant_counts()["simt_f32"]
    got = streamed_matmul(a, b, out_dtype=out_dtype)
    want = ref.matmul_ref(a, b, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert ops.matmul_variant_counts()["simt_f32"] == before + 1
    scale = want.abs().max().item()
    tol = (1e-5 if out_dtype == torch.float32 else 2 ** -8) * scale
    assert (got.float() - want).abs().max().item() <= tol


def test_fp32_matmul_reads_strided_rows(cuda):
    """Row strides of 97 floats (no 16-byte loads) and an odd base."""
    a = _rand((100, 97), torch.float32, cuda, 33)[:, :64]
    b = _rand((64 * 70 + 1,), torch.float32, cuda, 34)[1:].view(64, 70)
    got = streamed_matmul(a, b)
    want = ref.matmul_ref(a, b)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


# the transposed layouts on simt_f32: B as (n, k) and A as (k, m), at ragged
# shapes and an odd row stride (no 16-byte copies); 1e-5 of the largest output
@pytest.mark.parametrize("a_layout,b_layout", [("mk", "nk"), ("km", "kn")])
@pytest.mark.parametrize("m,k,n,pad", [(1000, 264, 1031, 0), (129, 37, 130, 0), (4, 2304, 5760, 0),
                                       (300, 200, 130, 1), (256, 1024, 256, 0)])
def test_fp32_matmul_transposed_layouts_match_plain(cuda, a_layout, b_layout, m, k, n, pad):
    ar, ac = (m, k) if a_layout == "mk" else (k, m)
    br, bc = (k, n) if b_layout == "kn" else (n, k)
    a = _rand((ar, ac + pad), torch.float32, cuda, 43)[:, :ac]
    b = _rand((br, bc + pad), torch.float32, cuda, 44)[:, :bc]
    before = ops.matmul_layout_counts()[f"{a_layout}/{b_layout}"]
    got = streamed_matmul(a, b, a_layout=a_layout, b_layout=b_layout)
    want = ref.matmul_ref(a, b, a_layout=a_layout, b_layout=b_layout)
    torch.cuda.synchronize()
    assert ops.matmul_layout_counts()[f"{a_layout}/{b_layout}"] == before + 1
    assert ops.matmul_variant_counts()["simt_f32"] > 0
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def test_fp32_matmul_rows_are_invariant_to_m(cuda):
    """Each output sums its K terms in ascending k in one chain, with no
    split: a row computed alone (m = 1) has the bits it has among 1000, and
    two runs are equal bit for bit."""
    a = _rand((1000, 1031), torch.float32, cuda, 45)
    b = _rand((1031, 517), torch.float32, cuda, 46)
    full = streamed_matmul(a, b)
    assert torch.equal(streamed_matmul(a, b), full)
    for i in (0, 1, 127, 128, 500, 999):
        assert torch.equal(streamed_matmul(a[i:i + 1], b), full[i:i + 1])
    assert torch.equal(streamed_matmul(a[130:390], b), full[130:390])


@pytest.mark.parametrize("b_layout", ["kn", "nk"])
@pytest.mark.parametrize("m,k,n", [(300, 264, 130), (1024, 1031, 517)])
def test_fp32_matmul_function_grads_on_the_card(cuda, b_layout, m, k, n):
    """The Function's fp32 backward on simt_f32 (dA with B in the other
    layout, dB with A read as its (k, m) transpose) against CPU autograd
    through the plain version: within 1e-5 of the largest gradient."""
    a = _rand((m, k), torch.float32, cuda, 47).requires_grad_(True)
    b = _rand((k, n) if b_layout == "kn" else (n, k), torch.float32, cuda, 48).requires_grad_(True)
    dc = _rand((m, n), torch.float32, cuda, 49)
    before = ops.matmul_variant_counts()["simt_f32"]
    out = ops.Matmul.apply(a, b, b_layout)
    da, db = torch.autograd.grad(out, (a, b), dc)
    assert ops.matmul_variant_counts()["simt_f32"] == before + 3
    ca, cb = (t.detach().cpu().requires_grad_(True) for t in (a, b))
    cout = ops.Matmul.apply(ca, cb, b_layout)
    wa, wb = torch.autograd.grad(cout, (ca, cb), dc.cpu())
    for got, want in ((out, cout), (da, wa), (db, wb)):
        assert got.dtype == torch.float32
        assert (got.cpu() - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_grid", [1, 2])
@pytest.mark.parametrize("compiled", [False, True])
def test_two_level_cannon_on_the_card(cuda, dtype, n_grid, compiled):
    """Algorithm 2 at n = 1024, M = 4 on the card, from pinned host operands:
    64 hypersteps, each one launch of the variant the dtype takes, C against
    the fp64 product. fp32: 1e-4 of max(|A|·|B|); bf16: each element within
    the error its roundings allow, from its own magnitudes: the kernel's
    fp32 sums (K·2^-23 of Σ|a||b|, an ulp an addition), each partial product
    P_s rounded to bf16 and each partial sum S_s (s ≥ 1) rounded by the bf16
    accumulator (2^-8 of |P_s| and of |S_s|), carried through the M
    additions."""
    from repro_torch.distributed.cannon import two_level_cannon

    n, m_blocks = 1024, 4
    g = np.random.default_rng(35)
    a32 = torch.from_numpy(g.standard_normal((n, n), dtype=np.float32))
    b32 = torch.from_numpy(g.standard_normal((n, n), dtype=np.float32))
    a, b = a32.to(dtype).pin_memory(), b32.to(dtype).pin_memory()
    variant = "simt_f32" if dtype == torch.float32 else "wgmma"
    before = ops.matmul_variant_counts()[variant]
    c, runner = two_level_cannon(a, b, m_blocks, n_grid=n_grid, compiled=compiled)
    assert ops.matmul_variant_counts()[variant] - before == m_blocks**3
    assert isinstance(c, torch.Tensor) and c.dtype == dtype and c.device.type == "cpu"
    ad, bd = a.to(cuda, torch.float64), b.to(cuda, torch.float64)
    big, u = n // m_blocks, 2.0**-8
    want, absab, magnitudes = (torch.zeros_like(ad) for _ in range(3))
    for s in range(m_blocks):   # every outer block adds P_0, P_1, ... in order
        cut = slice(s * big, (s + 1) * big)
        part = ad[:, cut] @ bd[cut, :]
        want += part
        absab += ad[:, cut].abs() @ bd[cut, :].abs()
        magnitudes += part.abs() + (want.abs() if s else 0.0)
    err = (c.to(cuda, torch.float64) - want).abs()
    if dtype == torch.float32:
        assert err.max().item() <= 1e-4 * absab.max().item()
    else:
        gamma = big * 2.0**-23 / (1 - big * 2.0**-23)
        bound = (1 + u) ** (2 * m_blocks) * (u * magnitudes + gamma * absab)
        assert bool((err <= bound).all()), (err / bound).max().item()
    assert runner.total_fetch_words == sum(runner.plan.fetch_schedule())


def _loop_cut():
    """A 2-layer, head-dim-64 minicpm-2b cut in bf16 with remat "full"."""
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("minicpm-2b", smoke=True), d_model=256, d_ff=512,
                               num_heads=4, num_kv_heads=4, dtype="bfloat16", remat="full")


def _train_on_card(cuda, cfg, steps, compiled, **kw):
    from repro_torch.core.bsp import BSPAccelerator
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim.adamw import AdamW
    from repro_torch.optim.schedule import constant
    from repro_torch.train import loop

    faults = kw.pop("faults", None)
    tcfg = loop.TrainConfig(steps=steps, log_every=1000, compiled=compiled, **kw)
    return loop.train(cfg, tcfg, AdamW(constant(3e-3)),
                      data_cfg=DataConfig(vocab_size=cfg.vocab_size, seq_len=128,
                                          global_batch=4, seed=0),
                      machine=BSPAccelerator(**HOST_PACK), calibstore=False,
                      log=lambda s: None, faults=faults, device=cuda)


def test_train_loop_modes_agree_on_the_card(cuda):
    """The training loop on the card: the compiled run and the host loop
    give equal losses and parameters bit for bit (the same eager step on
    the same batches), every step on the matmul and flash kernels."""
    from repro_torch.optim.adamw import leaves

    cfg = _loop_cut()
    before = ops.launch_counts()
    out_c = _train_on_card(cuda, cfg, 4, True)
    mid = ops.launch_counts()
    out_h = _train_on_card(cuda, cfg, 4, False)
    after = ops.launch_counts()
    losses = [h["loss"] for h in out_c["history"]]
    assert losses == [h["loss"] for h in out_h["history"]]
    assert all(np.isfinite(losses))
    for a, b in zip(leaves(out_c["params"]), leaves(out_h["params"])):
        assert a.is_cuda and torch.equal(a, b)
    for name in ("streamed_matmul", "flash_attention"):
        assert mid[name] - before[name] == after[name] - mid[name] > 0
    # per step: forward, remat recompute and two backward products each
    # (the head's recompute excepted); flash forward and recompute
    assert mid["streamed_matmul"] - before["streamed_matmul"] == 4 * (4 * (7 * 2 + 1) - 1)
    assert mid["flash_attention"] - before["flash_attention"] == 4 * 2 * 2
    for out in (out_c, out_h):
        row = out["plan_row"]
        assert row["fetch_words_planned"] == row["fetch_words_measured"]


def test_remat_dots_on_the_card(cuda):
    """``remat="dots"`` on the card: the loss and every gradient leaf of
    ``"full"`` bit for bit (the kept products are the ones ``"full"``
    recomputes, from the same inputs on the same kernel), with 3 matmul
    launches a product against ``"full"``'s 4 less the head's recompute,
    and flash launched twice a layer in both."""
    import dataclasses

    from repro_torch.models import model as M
    from repro_torch.optim.adamw import leaves
    from repro_torch.optim.compress import tree_map

    cfg = _loop_cut()
    params = M.init_params(cfg, 0, device="cuda")
    toks = torch.as_tensor(np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 129)),
                           device="cuda")
    runs = {}
    for remat in ("full", "dots"):
        live = tree_map(lambda t: t.detach().requires_grad_(True), params)
        before = ops.launch_counts()
        loss, _ = M.loss_fn(dataclasses.replace(cfg, remat=remat), live, toks[:, :-1],
                            toks[:, 1:], device="cuda")
        grads = torch.autograd.grad(loss, leaves(live))
        torch.cuda.synchronize()
        after = ops.launch_counts()
        runs[remat] = (loss.detach(), grads, {k: after[k] - before[k] for k in after})
    prods = 7 * cfg.num_layers + 1
    assert runs["full"][2]["streamed_matmul"] == 4 * prods - 1
    assert runs["dots"][2]["streamed_matmul"] == 3 * prods
    assert runs["full"][2]["flash_attention"] == runs["dots"][2]["flash_attention"] \
        == 2 * cfg.num_layers
    assert torch.equal(runs["full"][0], runs["dots"][0])
    assert all(torch.equal(a, b) for a, b in zip(runs["full"][1], runs["dots"][1]))


@pytest.mark.parametrize("compiled", [True, False])
def test_train_loop_crash_resumes_bit_exact_on_the_card(cuda, tmp_path, compiled):
    """A dispatch failure mid-interval: one resume from the card's
    checkpoint, and the uncrashed run's losses bit for bit."""
    from repro_torch.core.faults import FaultPlan, FaultSpec
    from repro_torch.optim.adamw import leaves
    from repro_torch.train import checkpoint as ckpt

    cfg = _loop_cut()
    base = _train_on_card(cuda, cfg, 6, compiled, ckpt_dir=str(tmp_path / "base"),
                          ckpt_every=3)
    inj = FaultPlan([FaultSpec("dispatch_fail", at=(1 if compiled else 4,))]).replay()
    res = _train_on_card(cuda, cfg, 6, compiled, ckpt_dir=str(tmp_path / "crash"),
                         ckpt_every=3, max_restarts=2, faults=inj)
    assert res["resumes"] == 1
    assert res["health"]["count_by_code"].get("BSPS212", 0) == 1
    assert [h["loss"] for h in res["history"]] == [h["loss"] for h in base["history"]]
    assert ckpt.latest_step(str(tmp_path / "crash")) == 6
    state, _ = ckpt.restore(str(tmp_path / "crash"), 6, {"params": res["params"]})
    for a, b in zip(leaves(state["params"]), leaves(res["params"])):
        assert a.is_cuda and a.dtype == b.dtype and torch.equal(a, b)


# -- the remaining model families' shapes ---------------------------------------------


@pytest.mark.parametrize("b,hq,hkv,sq,skv,causal", [
    (4, 96, 8, 256, 256, True),                # nemotron-4-340b's forward (GQA 96/8)
    (2, 8, 2, 100, 100, True),                 # GQA, ragged
    (1, 4, 4, 100, 300, True),                 # ragged queries at the end
    (2, 4, 1, 1, 128, True),                   # decode q_offset
    (2, 4, 2, 70, 70, False),                  # non-causal, ragged
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_lse", [False, True])
def test_flash_head_dim_192_matches_plain(cuda, b, hq, hkv, sq, skv, causal, dtype, with_lse):
    """Head dim 192 on both kernels, with and without the rows' lse: one
    launch each, the output within the tolerances of the other head dims
    (2e-4 fp32, 2e-2 bf16), the lse within 1e-3, the output with lse equal
    to the output without."""
    q = _rand((b, hq, sq, 192), dtype, cuda, 60)
    k = _rand((b, hkv, skv, 192), dtype, cuda, 61)
    v = _rand((b, hkv, skv, 192), dtype, cuda, 62)
    before = ops.launch_counts()["flash_attention"]
    got = flash_attention(q, k, v, causal=causal, return_lse=with_lse)
    assert ops.launch_counts()["flash_attention"] == before + 1
    want, want_lse = ref.attention_ref_lse(q, k, v, causal=causal)
    out = got[0] if with_lse else got
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    if with_lse:
        torch.testing.assert_close(got[1], want_lse, rtol=0, atol=1e-3)
        assert torch.equal(out, flash_attention(q, k, v, causal=causal))


@pytest.mark.parametrize("d", [8, 16, 32, 48, 96, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_lse", [False, True])
def test_flash_head_dims_match_plain(cuda, d, dtype, with_lse):
    """Head dims the kernel is built for (16, 32, 256) and ones it runs
    zero-padded to the next (8 → 16, 48 → 64, 96 → 128), on both kernels,
    GQA 4/2 with ragged queries at the end of the keys: one launch, the
    output in the documented layout within 2e-4 (fp32) and 2e-2 (bf16) of
    the plain version at the unpadded D's ``sm_scale``, the lse within
    1e-3."""
    q = _rand((2, 4, 100, d), dtype, cuda, 63)
    k = _rand((2, 2, 130, d), dtype, cuda, 64)
    v = _rand((2, 2, 130, d), dtype, cuda, 65)
    before = ops.launch_counts()["flash_attention"]
    got = flash_attention(q, k, v, return_lse=with_lse)
    assert ops.launch_counts()["flash_attention"] == before + 1
    want, want_lse = ref.attention_ref_lse(q, k, v)
    out = got[0] if with_lse else got
    assert out.shape == q.shape and out.transpose(1, 2).is_contiguous()
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    if with_lse:
        torch.testing.assert_close(got[1], want_lse, rtol=0, atol=1e-3)


def test_flash_head_dims_past_256_raise(cuda):
    """Head dim 320 has no kernel to run at: it raises, naming the limit,
    and nothing is launched."""
    q = _rand((1, 2, 64, 320), torch.bfloat16, cuda)
    before = ops.launch_counts()["flash_attention"]
    with pytest.raises(ValueError, match="up to 256"):
        flash_attention(q, q, q)
    assert ops.launch_counts()["flash_attention"] == before


# -- the fp32 kernel: register-tiled products, K/V streamed by cp.async -------------


def _fp32_flash_matches_plain(q, k, v, causal=True):
    """The fp32 kernel against the plain version: the output within 2e-4
    absolute and relative, the lse within 1e-3, and the output with lse
    equal to the output without."""
    out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    want, want_lse = ref.attention_ref_lse(q, k, v, causal=causal)
    torch.testing.assert_close(out, want, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-3)
    assert torch.equal(out, flash_attention(q, k, v, causal=causal))


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_flash_fp32_is_deterministic(cuda, d):
    """Each score is one ascending-d FMA chain, each output one
    ascending-key chain and l sums in a fixed order: two calls, the same
    bits."""
    q = _rand((2, 8, 200, d), torch.float32, cuda, 70)
    k = _rand((2, 2, 200, d), torch.float32, cuda, 71)
    v = _rand((2, 2, 200, d), torch.float32, cuda, 72)
    assert torch.equal(flash_attention(q, k, v), flash_attention(q, k, v))


@pytest.mark.parametrize("d", [64, 256])
def test_flash_fp32_long_causal_matches_plain(cuda, d):
    """Sq = Skv = 1000: 16 KV blocks through the K/V stream (double-buffered
    at D 64, one K and one V buffer at D 256), the last one ragged."""
    _fp32_flash_matches_plain(_rand((1, 4, 1000, d), torch.float32, cuda, 73),
                              _rand((1, 2, 1000, d), torch.float32, cuda, 74),
                              _rand((1, 2, 1000, d), torch.float32, cuda, 75))


@pytest.mark.parametrize("d", [64, 256])
def test_flash_fp32_reads_unaligned_rows(cuda, d):
    """fp32 rows need no 16-byte alignment: rows d + 1 floats apart from a
    base one float past a 16-byte boundary (Q, K and V by 4-byte copies)."""
    q, k, v = (_rand((2, h, s, d + 1), torch.float32, cuda, seed)[..., 1:]
               for h, s, seed in ((4, 100, 76), (2, 130, 77), (2, 130, 78)))
    assert q.stride(2) % 4 and k.data_ptr() % 16
    _fp32_flash_matches_plain(q, k, v)


def test_flash_fp32_reads_strided_heads(cuda):
    x = _rand((2, 100, 3, 4, 64), torch.float32, cuda, 79)   # (B, S, qkv, H, D)
    q, k, v = (x[:, :, i].transpose(1, 2) for i in range(3))
    _fp32_flash_matches_plain(q, k, v)


def test_flash_fp32_gqa_decode_row_at_head_dim_256(cuda):
    _fp32_flash_matches_plain(_rand((2, 16, 1, 256), torch.float32, cuda, 80),
                              _rand((2, 4, 300, 256), torch.float32, cuda, 81),
                              _rand((2, 4, 300, 256), torch.float32, cuda, 82))


# xlstm-1.3b's projections (mLSTM w_up / w_z 2048 -> 4096 and w_down 4096 ->
# 2048, sLSTM w_in 2048 -> 8192 and w_out) and nemotron-4-340b's MLP (18432 <->
# 73728): decode at m = 4, forward at m = 1024. K = 73728 at m <= 16 needs
# 8 x 9224 bf16 of A share a block (147 KB, past DECODE_A_MAX), so nemotron's
# decode down projection takes decode_deep (A streamed beside B); at 16 rows
# K = 18432 does too
@pytest.mark.parametrize("m,k,n,variant", [
    (4, 2048, 4096, "decode"), (4, 4096, 2048, "decode"), (4, 2048, 8192, "decode"),
    (4, 2048, 2048, "decode"), (1024, 2048, 4096, "wgmma"), (1024, 4096, 2048, "wgmma"),
    (1024, 2048, 8192, "wgmma"),
    (4, 18432, 73728, "decode"), (4, 73728, 18432, "decode_deep"),
    (1, 73728, 18432, "decode_deep"), (1024, 18432, 73728, "wgmma"),
    (1024, 73728, 18432, "wgmma"), (4, 18432, 256000, "decode"),
    (16, 18432, 73728, "decode_deep"), (16, 24576, 6144, "decode_deep"),
])
def test_matmul_at_the_families_shapes(cuda, m, k, n, variant):
    from repro_torch.kernels.streamed_matmul import decode_fits

    gen = torch.Generator(device=cuda).manual_seed(63)   # drawn on the card: B is up to 9.4 GB
    a = torch.randn((m, k), generator=gen, device=cuda).to(torch.bfloat16)
    b = (torch.randn((k, n), generator=gen, device=cuda) * k ** -0.5).to(torch.bfloat16)
    assert (m > 16 or decode_fits(m, k)) == (variant in ("decode", "wgmma"))
    assert (m <= 16 and not decode_fits(m, k)) == (variant == "decode_deep")
    before = ops.matmul_variant_counts()[variant]
    got = streamed_matmul(a, b)
    assert ops.matmul_variant_counts()[variant] == before + 1
    want = ref.matmul_ref(a, b)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


# decode_deep past the decode block's A share: ragged n and k (TMA zero-fills
# B's edge, A's slice copies zero past k, k = 32333 inside a 16-byte chunk),
# A's rows a multiple of 16 bytes apart (cp.async) or not (plain loads), B as
# (n, k), and fp32 output
@pytest.mark.parametrize("m,k,n,b_layout", [
    (1, 32328, 136, "kn"), (4, 32333, 200, "kn"), (8, 40000, 1000, "kn"),
    (9, 16000, 520, "kn"), (16, 20000, 264, "nk"), (13, 33000, 72, "nk"),
])
@pytest.mark.parametrize("a_pad", [0, 3])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_decode_deep_matches_plain(cuda, m, k, n, b_layout, a_pad, out_dtype):
    a = _rand((m, -(-k // 8) * 8 + a_pad), torch.bfloat16, cuda, 71)[:, :k]
    b = _rand((k, n) if b_layout == "kn" else (n, k), torch.bfloat16, cuda, 72) * k ** -0.5
    before = ops.matmul_variant_counts()["decode_deep"]
    got = streamed_matmul(a, b, out_dtype=out_dtype, b_layout=b_layout)
    want = ref.matmul_ref(a, b, out_dtype=out_dtype, b_layout=b_layout)
    torch.cuda.synchronize()
    assert ops.matmul_variant_counts()["decode_deep"] == before + 1
    tol = 2e-2 if out_dtype == torch.bfloat16 else 1e-3
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_decode_deep_rows_are_batch_invariant(cuda):
    """At nemotron's K = 73728 every m ≤ 8 takes decode_deep with one K
    split: a row alone gives the bits it gives among 8, and the first rows of
    16 alone (m = 9 .. 15) the bits they give among 16."""
    gen = torch.Generator(device=cuda).manual_seed(73)
    a = torch.randn((16, 73728), generator=gen, device=cuda).to(torch.bfloat16)
    b = (torch.randn((73728, 2048), generator=gen, device=cuda) * 73728 ** -0.5).to(
        torch.bfloat16)
    full = streamed_matmul(a[:8], b)
    for i in range(8):
        assert torch.equal(streamed_matmul(a[i:i + 1], b), full[i:i + 1])
    full = streamed_matmul(a, b)
    for r in (9, 12, 15):
        assert torch.equal(streamed_matmul(a[:r], b), full[:r])
    assert all(torch.equal(full, streamed_matmul(a, b)) for _ in range(2))


def test_decode_deep_is_one_launch(cuda):
    a = _rand((4, 73728), torch.bfloat16, cuda, 74)
    b = _rand((73728, 256), torch.bfloat16, cuda, 75)
    ops.reset_launch_counts()
    ops.matmul(a, b)
    assert ops.launch_counts()["streamed_matmul"] == 1
    assert ops.matmul_variant_counts()["decode_deep"] == 1


def test_forced_decode_wmma_matches_the_rule(cuda):
    """``variant="decode_cp"`` where the rule gives ``decode_deep`` gives
    its bits (the same split, consumers and sum order), and where it gives
    ``decode`` the same product within two ulps; ``variant="wgmma_cp"``
    gives ``wgmma``'s bits (the same stage bytes and consumers), ragged
    edges included. Any other forced variant raises."""
    for out_dtype in (torch.float32, torch.bfloat16):
        for k in (40000, 5760):                  # decode_deep, decode
            a = _rand((4, k), torch.bfloat16, cuda, 76)
            b = _rand((k, 2304), torch.bfloat16, cuda, 77) * k ** -0.5
            want = streamed_matmul(a, b, out_dtype=out_dtype)
            before = ops.matmul_variant_counts()["decode_cp"]
            got = streamed_matmul(a, b, out_dtype=out_dtype, variant="decode_cp")
            assert ops.matmul_variant_counts()["decode_cp"] == before + 1
            if k == 40000:
                assert torch.equal(got, want)
            else:
                tol = 2e-2 if out_dtype == torch.bfloat16 else 1e-3
                torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
        for m, k, n in ((1024, 2304, 5760), (1000, 264, 1032), (17, 8, 8)):
            a = _rand((m, k), torch.bfloat16, cuda, 78)
            b = _rand((k, n), torch.bfloat16, cuda, 79) * k ** -0.5
            want = streamed_matmul(a, b, out_dtype=out_dtype)
            before = ops.matmul_variant_counts()["wgmma_cp"]
            got = streamed_matmul(a, b, out_dtype=out_dtype, variant="wgmma_cp")
            assert ops.matmul_variant_counts()["wgmma_cp"] == before + 1
            assert torch.equal(got, want)
    a = _rand((4, 5760), torch.bfloat16, cuda, 76)
    b = _rand((5760, 2304), torch.bfloat16, cuda, 77)
    for variant, layout in (("wgmma", "kn"), ("decode_deep", "kn"), ("decode_cp", "nk"),
                            ("wgmma_cp", "kn"), ("decode_wmma", "kn")):
        with pytest.raises(ValueError, match="cannot take"):
            streamed_matmul(a, b if layout == "kn" else b.T.contiguous(), b_layout=layout,
                            variant=variant)


# operands TMA cannot describe: (A's base offset, pad past k of A's rows,
# B's base offset, pad past n of B's rows) in elements, and k, n (ragged)
_UNALIGNED = [(0, 0, 0, 1, 200, 130), (1, 0, 0, 3, 200, 130), (0, 1, 1, 0, 200, 130),
              (3, 5, 5, 3, 75, 257), (7, 2, 2, 7, 130, 9), (4, 4, 6, 0, 64, 200),
              (5, 3, 7, 5, 1000, 300), (2, 6, 3, 2, 17, 1031)]


def _strided(rows, cols, offset, pad, device, seed, scale=1.0):
    """A (rows, cols) bf16 view whose rows are cols + pad apart, ``offset``
    elements into its buffer."""
    ld = cols + pad
    buf = _rand((offset + rows * ld,), torch.bfloat16, device, seed) * scale
    return buf.as_strided((rows, cols), (ld, 1), offset)


@pytest.mark.parametrize("m", [1, 8, 9, 16, 17, 300])
@pytest.mark.parametrize("a_off,a_pad,b_off,b_pad,k,n", _UNALIGNED)
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_copy_variants_read_unaligned_operands(cuda, m, a_off, a_pad, b_off, b_pad, k, n,
                                               out_dtype):
    """Base offsets of 0-7 elements and row strides that are not a multiple
    of 16 bytes, at ragged m, n and k: B is never TMA-describable, so m ≤ 16
    takes decode_cp and m > 16 wgmma_cp, each against the plain version."""
    a = _strided(m, k, a_off, a_pad, cuda, 80)
    b = _strided(k, n, b_off, b_pad, cuda, 81, k ** -0.5)
    variant = "decode_cp" if m <= 16 else "wgmma_cp"
    before = ops.matmul_variant_counts()[variant]
    got = streamed_matmul(a, b, out_dtype=out_dtype)
    want = ref.matmul_ref(a, b, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert ops.matmul_variant_counts()[variant] == before + 1
    tol = 2e-2 if out_dtype == torch.bfloat16 else 1e-3
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("m,k,n,variant", [
    (4, 2304, 5761, None), (16, 18432, 2049, None),         # decode_cp, unaligned B
    (300, 200, 130, None), (1024, 2304, 5761, None),        # wgmma_cp, unaligned B
    (4, 73728, 256, "decode_cp"), (1024, 2304, 5760, "wgmma_cp"),   # forced, aligned
])
def test_copy_variants_repeat_their_bits(cuda, m, k, n, variant):
    """20 launches on the same inputs give the same bits: a stage read
    before all of its copies are visible (a missing barrier arrival or proxy
    fence) shows as bits that change now and then."""
    a = _rand((m, k), torch.bfloat16, cuda, 82)
    b = _rand((k, n), torch.bfloat16, cuda, 83) * k ** -0.5
    name = variant or ("decode_cp" if m <= 16 else "wgmma_cp")
    before = ops.matmul_variant_counts()[name]
    one = streamed_matmul(a, b, variant=variant)
    assert ops.matmul_variant_counts()[name] == before + 1
    assert all(torch.equal(one, streamed_matmul(a, b, variant=variant)) for _ in range(20))


@pytest.mark.parametrize("k,n", [(2304, 5761), (5761, 2305), (18432, 2049)])
def test_decode_cp_rows_alone_equal_the_batch(cuda, k, n):
    """decode_cp's split depends on m only through the instance (1-8 or
    9-16), so a row alone rounds as it does among 8, and the first r rows of
    16 as they do among 16."""
    a = _rand((16, k), torch.bfloat16, cuda, 84)
    b = _rand((k, n), torch.bfloat16, cuda, 85) * k ** -0.5
    before = ops.matmul_variant_counts()["decode_cp"]
    full8 = streamed_matmul(a[:8], b)
    assert ops.matmul_variant_counts()["decode_cp"] == before + 1
    assert all(torch.equal(streamed_matmul(a[i:i + 1], b), full8[i:i + 1]) for i in range(8))
    full16 = streamed_matmul(a, b)
    assert all(torch.equal(streamed_matmul(a[:r], b), full16[:r]) for r in range(9, 16))


# the scan's backward against its plain version. fp32: sums in another order
# and ex2.approx for exp, within 1e-4 of each gradient's largest entry;
# bf16 streams: the same fp32 walk from the same bf16 inputs, dx, dΔ, dB, dC
# rounded once to bf16 on each side (two ulps of the largest), dA and dD
# fp32 on both sides (1e-4)
def _bwd_close(got, want):
    for name, g, w in zip(("dx", "ddt", "db", "dc", "da", "dd"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert bool(torch.isfinite(g).all()), name
        tol = 2 * 2 ** -8 if g.dtype == torch.bfloat16 else 1e-4
        scale = w.float().abs().max().item()
        assert (g.float() - w.float()).abs().max().item() <= tol * scale, name


def _bwd_inputs(b, seq, di, ds, dtype, device, seed):
    return (*_ssm_inputs(b, seq, di, ds, dtype, device, seed),
            _rand((b, seq, di), dtype, device, seed + 1))


@pytest.mark.parametrize("b,seq,di,ds", [
    (4, 256, 8192, 16),        # jamba's train step
    (2, 300, 1000, 16),        # ragged d_inner and L
    (1, 130, 200, 8),          # d_state 8, ragged
    (3, 5, 64, 16),            # shorter than one segment
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_bwd_kernel_matches_plain(cuda, b, seq, di, ds, dtype):
    args = _bwd_inputs(b, seq, di, ds, dtype, cuda, 40)
    got = ssm_scan_bwd(*args)
    want = ref.ssm_scan_bwd_ref(*args)
    torch.cuda.synchronize()
    _bwd_close(got, want)


@pytest.mark.parametrize("ds,lanes", [(16, (2, 4, 8)), (8, (2, 4))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_bwd_bits_do_not_depend_on_lanes_or_run(cuda, ds, lanes, dtype):
    """The backward has one grouping of its own; the tape it reads comes
    from a forward of any lane grouping (and chunk). Every such tape, and a
    second run, give the same bits: no atomics, every sum in one order."""
    args = _bwd_inputs(2, 300, 1000, ds, dtype, cuda, 42)
    tapes = [ssm_scan_with_tape(*args[:6], lanes=n)[1] for n in lanes]
    tapes.append(ssm_scan_with_tape(*args[:6], chunk=16)[1])
    runs = [ssm_scan_bwd(*args, tape=t) for t in tapes]
    runs.append(ssm_scan_bwd(*args))
    _bwd_close(runs[0], ref.ssm_scan_bwd_ref(*args))
    for t in tapes[1:]:
        assert torch.equal(t, tapes[0])
    for other in runs[1:]:
        assert all(torch.equal(g, h) for g, h in zip(runs[0], other))


@pytest.mark.parametrize("b,seq,di,ds", [
    (4, 256, 8192, 16),        # jamba's train step
    (2, 300, 1000, 16),        # ragged d_inner and L
    (1, 130, 200, 8),          # d_state 8, ragged
    (3, 5, 64, 16),            # shorter than one segment: no tape
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_forward_tape_matches_the_plain_walk(cuda, b, seq, di, ds, dtype):
    """The forward with the tape: y the same bits as without it, and the
    tape within 1e-4 of its largest state of the plain walk's states at the
    segment starts (``ssm_scan_tape_ref``; fp32 on both sides, ex2.approx
    for exp)."""
    x, dt, bb, c, a, d = _ssm_inputs(b, seq, di, ds, dtype, cuda, 47)
    y, tape = ssm_scan_with_tape(x, dt, bb, c, a, d)
    assert torch.equal(y, ssm_scan(x, dt, bb, c, a, d))
    want = ref.ssm_scan_tape_ref(x, dt, bb, a, SEGMENT)
    if seq <= SEGMENT:
        assert tape is None and want.shape[1] == 0
        return
    assert tape.shape == want.shape and tape.dtype == torch.float32
    err = (tape - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item()


def test_ssm_bwd_row_alone_matches_the_batch(cuda):
    """A row alone takes the tiles, stages and sums' order it takes in a
    batch of 4: its dx, dΔ, dB and dC are the same bits."""
    args = _bwd_inputs(4, 100, 8192, 16, torch.bfloat16, cuda, 43)
    full = ssm_scan_bwd(*args)
    row = ssm_scan_bwd(*(t[2:3].contiguous() for t in args[:4]), *args[4:6],
                       args[6][2:3].contiguous())
    for g, r in zip(full[:4], row[:4]):
        assert torch.equal(g[2:3], r)


def test_ssm_bwd_entry_refuses_another_work_layout(cuda, monkeypatch):
    """The caller allocates the dB/dC partials from ``bwd_work_shapes``, one
    per tile of the backward's channels; where its tile is not the kernel's
    (here 32 channels, a 128-thread block), the entry refuses the launch and
    nothing runs. So does a tape of another shape."""
    from repro_torch.kernels import ssm_scan as scan_mod

    args = _bwd_inputs(1, 20, 64, 16, torch.float32, cuda, 45)
    before = ops.launch_counts()["ssm_scan_bwd"]
    with pytest.raises(ValueError, match="tape"):
        ssm_scan_bwd(*args, tape=torch.zeros(1, 3, 64, 16, device=cuda))
    monkeypatch.setattr(scan_mod, "BWD_THREADS", 128)
    with pytest.raises(RuntimeError, match="bsps_ssm_scan_bwd failed"):
        ssm_scan_bwd(*args)
    assert ops.launch_counts()["ssm_scan_bwd"] == before


def test_selective_scan_function_on_the_card(cuda):
    """Under autograd the scan goes through ``SelectiveScan``: one forward
    launch, which writes the tape beside y, and one backward launch, the
    backward kernel's gradients. ``ssm_scan_bwd`` without a tape launches
    the forward with the tape first."""
    x, dt, bb, c, a, d, dy = _bwd_inputs(2, 64, 256, 16, torch.bfloat16, cuda, 44)
    live = [t.clone().requires_grad_(True) for t in (x, dt, bb, c, a, d)]
    before = ops.launch_counts()
    y = ops.selective_scan(*live)
    assert len(y.grad_fn.saved_tensors) == 7                     # the operands and the tape
    assert torch.equal(y.grad_fn.saved_tensors[6], ssm_scan_with_tape(x, dt, bb, c, a, d)[1])
    assert torch.equal(y, ssm_scan(x, dt, bb, c, a, d))
    grads = torch.autograd.grad(y, live, dy)
    after = ops.launch_counts()
    assert after["ssm_scan"] - before["ssm_scan"] == 3          # the checks' calls too
    assert after["ssm_scan_bwd"] - before["ssm_scan_bwd"] == 1
    alone = ssm_scan_bwd(x, dt, bb, c, a, d, dy)
    last = ops.launch_counts()
    assert last["ssm_scan"] - after["ssm_scan"] == 1
    assert last["ssm_scan_bwd"] - after["ssm_scan_bwd"] == 1
    for g, w in zip(grads, alone):
        assert torch.equal(g, w)


def test_jamba_train_step_on_the_card(cuda):
    """A one-period jamba cut (head dim 64, d_inner 512, d_state 16): the
    loss and every gradient leaf on the card against fp32 autograd on the
    CPU through the plain versions, on the same weights and tokens, every
    MoE layer on the routes of the card's bf16 run (``moe.route_hook``).
    In fp32 on the card (the scan's backward kernel, the matmul's
    ``simt_f32``, the flash kernel forward) every leaf lies within 1e-4
    (relative L2) of the CPU's: sums in another order. In bf16 (bf16
    weights, activations and gradients over 8 layers) every leaf lies
    within 0.1 (relative L2; the worst measured on the H100 is 0.061), the
    loss within 2% and the gradient norm within 5%. A train step then launches
    the backward once for each of its 7 Mamba layers."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.optim.adamw import AdamW, global_norm, leaves
    from repro_torch.optim.compress import tree_map
    from repro_torch.optim.schedule import constant
    from repro_torch.train.steps import make_train_step

    cfg = dataclasses.replace(get_config("jamba-v0.1-52b", smoke=True), d_model=256,
                              num_heads=4, num_kv_heads=2, d_ff=512, moe_d_ff=512,
                              ssm_d_state=16, moe_capacity_factor=8.0, dtype="bfloat16")
    f32 = dataclasses.replace(cfg, dtype="float32")
    params = M.init_params(cfg, 0, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 65), generator=torch.Generator().manual_seed(5))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    routes = []

    def grads_on(cfg, params, device, hook):
        live = tree_map(lambda t: t.detach().requires_grad_(True), params)
        with moe.route_hook(hook):
            loss, _ = M.loss_fn(cfg, live, batch["tokens"].to(device),
                                batch["labels"].to(device), device=device)
            return float(loss.detach()), torch.autograd.grad(loss, leaves(live))

    def record(probs, top_e):
        routes.append(top_e.cpu())
        return top_e

    def replay():
        it = iter(routes)
        return lambda probs, top_e: next(it).to(top_e.device)

    before = ops.launch_counts()
    loss, got = grads_on(cfg, params, cuda, record)
    assert ops.launch_counts()["ssm_scan_bwd"] - before["ssm_scan_bwd"] == 7
    _, got32 = grads_on(f32, tree_map(lambda t: t.float(), params), cuda, replay())
    want_loss, want = grads_on(f32, tree_map(lambda t: t.float().cpu(), params), "cpu",
                               replay())
    for g, w in zip(got32, want):
        err = torch.linalg.vector_norm(g.cpu() - w) / torch.linalg.vector_norm(w)
        assert float(err) <= 1e-4
    assert all(bool(torch.isfinite(g).all()) for g in got)
    for g, w in zip(got, want):
        err = torch.linalg.vector_norm(g.float().cpu() - w) / torch.linalg.vector_norm(w)
        assert float(err) <= 0.1
    assert abs(loss - want_loss) <= 0.02 * want_loss
    norm, want_norm = float(global_norm(list(got))), float(global_norm(list(want)))
    assert abs(norm - want_norm) <= 0.05 * want_norm
    opt = AdamW(constant(1e-3))
    before = ops.launch_counts()
    make_train_step(cfg, opt, device=cuda)(params, opt.init(params),
                                           {k: v.to(cuda) for k, v in batch.items()})
    after = ops.launch_counts()
    assert after["ssm_scan_bwd"] - before["ssm_scan_bwd"] == 7
    assert after["ssm_scan"] - before["ssm_scan"] == 7         # remat "none": no recompute


# -- the roofline counter: one count on both devices -----------------------------------


def _count_on(device, fn, *tensors):
    from repro_torch.core import roofline

    moved = [t.to(device) for t in tensors]
    with roofline.count() as c:
        fn(*moved)
    return c


@pytest.mark.parametrize("kernel", ["matmul", "matmul_nk", "dot", "attention", "scan",
                                    "scan_backward", "attention_backward"])
def test_kernel_counts_equal_on_both_devices(cuda, kernel):
    """Each wrapper records its kernel's formula on the card, where it
    launches, and on the CPU, where its plain version runs: the same FLOPs,
    bytes and calls, and none of the plain version's torch ops."""
    bf = torch.bfloat16
    if kernel in ("matmul", "matmul_nk"):
        layout = "kn" if kernel == "matmul" else "nk"
        args = (_rand((100, 256), bf, "cpu", 1), _rand((256, 136), bf, "cpu", 2))
        fn = lambda a, b: ops.matmul(a, b if layout == "kn" else b.T.contiguous(),
                                     b_layout=layout)
    elif kernel == "dot":
        args = (_rand((5000,), torch.float32, "cpu", 1), _rand((5000,), torch.float32, "cpu", 2))
        fn = ops.dot
    elif kernel == "attention":
        args = (_rand((2, 8, 100, 64), bf, "cpu", 1), _rand((2, 2, 100, 64), bf, "cpu", 2),
                _rand((2, 2, 100, 64), bf, "cpu", 3))
        fn = lambda q, k, v: ops.attention(q, k, v, return_lse=True)
    elif kernel == "attention_backward":
        from repro_torch.models.flash import FlashAttention

        args = (_rand((2, 8, 100, 64), bf, "cpu", 1), _rand((2, 2, 100, 64), bf, "cpu", 2),
                _rand((2, 2, 100, 64), bf, "cpu", 3))

        def fn(*t):      # dout a broadcast of ones (stride 0): the wrapper stages it
            live = [u.detach().requires_grad_(True) for u in t]
            FlashAttention.apply(*live, True).sum().backward()
    else:
        x = _rand((2, 40, 256), torch.float32, "cpu", 1)
        dt = _rand((2, 40, 256), torch.float32, "cpu", 2).abs() * 0.05
        bb, cc = _rand((2, 40, 16), torch.float32, "cpu", 3), _rand((2, 40, 16), torch.float32,
                                                                   "cpu", 4)
        a = -torch.arange(1, 17, dtype=torch.float32).expand(256, 16).contiguous()
        d = _rand((256,), torch.float32, "cpu", 5)
        args = (x, dt, bb, cc, a, d)
        if kernel == "scan":
            fn = ops.selective_scan
        else:
            def fn(*t):
                live = [u.detach().requires_grad_(True) for u in t]
                ops.selective_scan(*live).sum().backward()
    card, cpu = _count_on(cuda, fn, *args), _count_on("cpu", fn, *args)
    assert card.kernels == cpu.kernels and card.kernels
    assert (card.flops, card.bytes, card.launches) == (cpu.flops, cpu.bytes, cpu.launches)
    if kernel not in ("matmul_nk", "scan_backward", "attention_backward"):
        assert card.ops == cpu.ops == {}


def test_two_layer_cut_counts_equal_on_both_devices(cuda):
    """A 2-layer full-width minicpm-2b cut's forward and train step count
    the same work on the card as on the CPU, op for op."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import roofline
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import AdamW
    from repro_torch.optim.schedule import constant
    from repro_torch.train.steps import make_prefill_step, make_train_step

    cfg = dataclasses.replace(get_config("minicpm-2b"), num_layers=2)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 33))
    counts = {}
    for device in (cuda, torch.device("cpu")):
        params = M.init_params(cfg, 0, device=device)
        batch = {"tokens": torch.as_tensor(toks[:, :-1], dtype=torch.int32, device=device),
                 "labels": torch.as_tensor(toks[:, 1:], dtype=torch.int64, device=device)}
        with roofline.count() as fwd:
            make_prefill_step(cfg, device=device)(params, {"tokens": batch["tokens"]})
        opt = AdamW(constant(1e-3))
        with roofline.count() as train:
            make_train_step(cfg, opt, device=device)(params, opt.init(params), batch)
        counts[device.type] = (fwd, train)
    for card, cpu in zip(counts["cuda"], counts["cpu"]):
        assert card.ops == cpu.ops
        assert card.kernels == cpu.kernels
        assert (card.flops, card.bytes) == (cpu.flops, cpu.bytes)
