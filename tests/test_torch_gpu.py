"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device: the kernels have no CPU mode. They skip
(from the ``cuda`` fixture) where there is none. On the card run
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.streamed_dot import streamed_dot
from repro_torch.kernels.streamed_matmul import streamed_matmul

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(shape, dtype, device, seed=0):
    g = np.random.default_rng(seed)
    return torch.as_tensor(g.standard_normal(shape), dtype=torch.float32).to(device, dtype)


# bf16 products: fp32 accumulation on both sides, one bf16 rounding of the
# output (relative 2^-8), so the kernel and the plain version differ by at
# most about one output ulp
@pytest.mark.parametrize("m,k,n", [
    (4, 2304, 5760), (4, 5760, 2304),          # decode MLP (split K)
    (1024, 2304, 5760),                        # prefill MLP
    (300, 200, 130), (1, 37, 9), (17, 64, 65),  # ragged
])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_matmul_kernel_matches_plain(cuda, m, k, n, out_dtype):
    a = _rand((m, k), torch.bfloat16, cuda, 1)
    b = _rand((k, n), torch.bfloat16, cuda, 2) * k ** -0.5
    got = streamed_matmul(a, b, out_dtype=out_dtype)
    want = ref.matmul_ref(a, b, out_dtype=out_dtype)
    torch.cuda.synchronize()
    tol = 2e-2 if out_dtype == torch.bfloat16 else 1e-3
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_matmul_kernel_strided_rows(cuda):
    a = _rand((8, 96), torch.bfloat16, cuda)[:, :64]     # row stride 96
    b = _rand((64, 72), torch.bfloat16, cuda, 3)
    torch.testing.assert_close(streamed_matmul(a, b, out_dtype=torch.float32),
                               ref.matmul_ref(a, b, out_dtype=torch.float32),
                               rtol=1e-3, atol=1e-3)


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
    assert ops.launch_counts() == {"streamed_dot": 1, "streamed_matmul": 1,
                                   "flash_attention": 1}


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    with pytest.raises(TypeError):
        streamed_matmul(torch.ones(4, 4, device=cuda), torch.ones(4, 4, device=cuda))
    q = torch.ones(1, 1, 8, 32, device=cuda)
    with pytest.raises(ValueError):
        flash_attention(q, q, q)


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
    from repro_torch.core.bsp import EPIPHANY_III
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as M

    cfg = dataclasses.replace(get_config("minicpm-2b", smoke=True), d_model=256,
                              d_ff=512, num_heads=4, num_kv_heads=4, dtype="bfloat16")
    params = M.init_params(cfg, 0, device=cuda)
    prompt = torch.randint(0, cfg.vocab_size, (2, 70), generator=torch.Generator().manual_seed(0))
    before = ops.launch_counts()["streamed_matmul"]
    a, sa = generate(cfg, params, prompt, steps=5, machine=EPIPHANY_III, device=cuda)
    b, sb = generate(cfg, params, prompt, steps=5, machine=EPIPHANY_III, device=cuda,
                     compiled=False)
    assert torch.equal(a, b) and tuple(a.shape) == (2, 75)
    assert ops.launch_counts()["streamed_matmul"] > before
    assert sa.plan_row["fetch_words_planned"] == sa.plan_row["fetch_words_measured"]
