"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA GPU with ``nvcc`` (the kernel is built at
first use) and carries the ``cuda`` marker; without a card each test skips
with its reason. This file imports no JAX, so it also runs where only
PyTorch is installed:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda --noconftest -p no:cacheprovider

Run on the card, the tests cover the bf16 kernels' wgmma + TMA tilings
(:data:`TILING_CASES`). Tolerances: bf16 ``out`` 2e-2 absolute (the kernel rounds P to bf16 inside
its tensor-core product and stores ``out`` in bf16), ``lse`` 1e-3; f32 1e-4
(FMA order differs from the plain version's einsum; f32 matrix products
run in full f32, PyTorch's default, which no test here changes). The
backward pair: max |kernel - plain| / max |plain| on each of dq, dk, dv,
2e-2 in bf16 (the kernels round P and dS to bf16 as tensor-core operands,
where the plain version keeps f32, and store bf16 gradients) and 1e-4 in
f32. The trainer slice's CUDA paths: the DevicePrefetcher's copies from
pinned memory on a side stream give every batch bit for bit, and a
prefetched Trainer run gives the losses of an unprefetched one exactly.
The conv zoo's library paths: ``f32_matmul`` on bf16 operands (tensor
cores, f32 result) against the f32 product of the same bf16 values, 1e-2
relative L2 forward and backward (the backward rounds the cotangent to bf16,
2^-8); an f32 convolution, forward and backward, with both TF32 switches
left at PyTorch's defaults, against the CPU at 1e-5 relative L2 (TF32 would
give ~1e-3); the fused batch norm against the CPU's plain one at 1e-5
relative and absolute (the scale gradient sums 1568 terms in f32).
The sequence models: ``f32_bmm`` as ``f32_matmul`` (bf16 at 1e-2), and in
f32 with ``allow_tf32`` switched on against the CPU at 1e-5; composed
attention with dropout off, the small NMT Transformer (flash, f32), the
stacked LSTM and machine_translation against the CPU (loss 1e-5 relative,
gradients 1e-4 relative L2), and the beam search token for token.
Decode serving: the engine's paged decode step on the card against the
CPU (logits and written pages 1e-4), the engine on the card (starved page
pool, speculative self-draft) against the card's ``generate()`` token for
token, and ``generate_beam`` with its flash prefill against the CPU (the
same beams, scores 1e-4).
"""

import torch_threads  # noqa: F401  (first: its share of the cores)
import importlib

import pytest
import torch

tfa = importlib.import_module("paddle_tpu_torch.ops.cuda.flash_attention")

pytestmark = pytest.mark.cuda

TOL = {torch.bfloat16: (2e-2, 1e-3), torch.float32: (1e-4, 1e-4)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _qkv(cuda, B, H, H_kv, T, d, dtype, T_kv=None, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    T_kv = T if T_kv is None else T_kv

    def r(*s):
        return torch.randn(*s, generator=g, device=cuda).to(dtype)

    return r(B, H, T, d), r(B, H_kv, T_kv, d), r(B, H_kv, T_kv, d)


# (case, B, H, H_kv, T, T_kv, d, dtype, kwargs)
CASES = [
    ("causal_bf16", 2, 4, 4, 256, 256, 64, torch.bfloat16, dict(causal=True)),
    ("noncausal_ragged", 1, 2, 2, 100, 77, 64, torch.bfloat16, dict(causal=False)),
    ("gqa_t192", 2, 4, 2, 192, 192, 64, torch.bfloat16, dict(causal=True)),
    ("window", 1, 4, 4, 300, 300, 64, torch.bfloat16, dict(causal=True, window=70)),
    ("kv_len", 3, 2, 2, 256, 256, 64, torch.bfloat16, dict(causal=True, kv_len=[256, 1, 130])),
    ("kv_len_noncausal", 2, 2, 1, 64, 200, 32, torch.bfloat16, dict(kv_len=[3, 199])),
    # the NMT encoder's path: non-causal, lengths in [T/2, T] on both sides
    # of the 128-key tile
    ("kv_len_nmt", 4, 8, 8, 256, 256, 64, torch.bfloat16, dict(kv_len=[128, 129, 200, 256])),
    ("q_off", 1, 2, 2, 64, 192, 64, torch.bfloat16, dict(causal=True, q_off=128)),
    ("d32", 1, 2, 2, 128, 128, 32, torch.bfloat16, dict(causal=True)),
    ("d128", 1, 2, 2, 130, 130, 128, torch.bfloat16, dict(causal=True)),
    ("f32_t192", 1, 4, 2, 192, 192, 64, torch.float32, dict(causal=True, window=50)),
    ("f32_d128", 1, 2, 2, 70, 70, 128, torch.float32, dict()),
    ("f32_d32", 1, 2, 2, 64, 64, 32, torch.float32, dict(causal=True, kv_len=[40])),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_flash_fwd_kernel_matches_plain(cuda, case):
    name, B, H, H_kv, T, T_kv, d, dtype, kw = case
    kw = dict(kw)
    q, k, v = _qkv(cuda, B, H, H_kv, T, d, dtype, T_kv)
    if "kv_len" in kw:
        kw["kv_len"] = torch.tensor(kw["kv_len"], dtype=torch.int32, device=cuda)
    before = tfa.FLASH_FWD.launches
    out, lse = tfa.flash_attention_with_lse(q, k, v, **kw)
    torch.cuda.synchronize()
    assert tfa.FLASH_FWD.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape and lse.shape == (B, H, T, 1)
    ref, ref_lse = tfa._reference_attention_with_lse(
        q, k, v, kw.get("causal", False), 1.0 / d ** 0.5, kw.get("kv_len"),
        kw.get("window"), kw.get("q_off", 0), kw.get("k_off", 0))
    tol, tol_lse = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=tol)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=tol_lse)


def test_flash_fwd_rows_without_live_key(cuda):
    """k_off places the keys after the first 100 q rows: those rows have no
    live key, are skipped by the kernel's loop bounds and are defined only by
    lse < -1e8; the others match the plain version."""
    q, k, v = _qkv(cuda, 1, 2, 2, 256, 64, torch.bfloat16)
    out, lse = tfa.flash_attention_with_lse(q, k, v, causal=True, k_off=100)
    ref, ref_lse = tfa._reference_attention_with_lse(q, k, v, True, 0.125, k_off=100)
    live = torch.arange(256, device=cuda) >= 100
    torch.testing.assert_close(out[:, :, live].float(), ref[:, :, live].float(), rtol=0, atol=2e-2)
    torch.testing.assert_close(lse[:, :, live], ref_lse[:, :, live], rtol=0, atol=1e-3)
    assert bool((lse[:, :, ~live] < -1e8).all()) and bool(torch.isfinite(out).all())


def test_flash_fwd_refuses_what_it_does_not_take(cuda):
    from paddle_tpu_torch.core.enforce import EnforceError

    q, k, v = _qkv(cuda, 1, 2, 2, 64, 48, torch.bfloat16)
    with pytest.raises(EnforceError, match="head dim"):
        tfa.flash_attention(q, k, v)
    q, k, v = _qkv(cuda, 1, 2, 2, 64, 64, torch.float16)
    with pytest.raises(EnforceError, match="dtype"):
        tfa.flash_attention(q, k, v)
    q, k, v = _qkv(cuda, 1, 2, 2, 64, 64, torch.bfloat16)
    with pytest.raises(EnforceError, match="contiguous"):
        tfa.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    with torch.no_grad():  # no gradient is needed: the kernel runs
        assert tfa.flash_attention(q, k, v).shape == q.shape
    g = torch.ones_like(q)
    with pytest.raises(EnforceError, match="contiguous"):  # the backward checks too
        tfa._flash_bwd_dq_cuda(q, k, v, g.transpose(2, 3), torch.zeros(1, 2, 64, 1, device=cuda),
                               torch.zeros(1, 2, 64, 1, device=cuda), True, 0.125)
    with pytest.raises(EnforceError, match="lse"):
        tfa._flash_bwd_dkv_cuda(q, k, v, g, torch.zeros(1, 2, 64, 1, device=cuda, dtype=torch.bfloat16),
                                torch.zeros(1, 2, 64, 1, device=cuda), True, 0.125)


@pytest.mark.parametrize("sm_scale", [-0.125, 0.0])
def test_flash_kernels_take_any_scale(cuda, sm_scale):
    """A negative or zero sm_scale means what it means to the plain version:
    the bf16 forward scales before it takes the row max. T = 200 with a
    window gives masked, partly live and ragged tiles. At scale 0, dq and dk
    are exactly 0 in both versions."""
    q, k, v = _qkv(cuda, 2, 4, 2, 200, 64, torch.bfloat16)
    g = _qkv(cuda, 2, 4, 4, 200, 64, torch.bfloat16, seed=1)[0]
    kw = dict(causal=True, window=70, sm_scale=sm_scale)
    out, lse = tfa.flash_attention_with_lse(q, k, v, **kw)
    dq, dk, dv = tfa.flash_attention_bwd_block(q, k, v, out, lse, g, **kw)
    torch.cuda.synchronize()
    ref, ref_lse = tfa._reference_attention_with_lse(q, k, v, True, sm_scale, None, 70)
    tol, tol_lse = TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=tol)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=tol_lse)
    args = (q, k, v, g, lse, (g.float() * out.float()).sum(-1, keepdim=True), True, sm_scale,
            None, 70, 0, 0)
    ref_dk, ref_dv = tfa._flash_bwd_dkv_reference(*args)
    ref_dq = tfa._flash_bwd_dq_reference(*args)
    for got, want in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        assert bool(torch.isfinite(got).all())
        err = float((got.float() - want.float()).abs().max() / max(float(want.float().abs().max()), 1e-30))
        assert err <= BWD_TOL[torch.bfloat16], err


def test_generate_on_cuda_matches_cpu(cuda):
    """The tiny LM decodes the same greedy tokens on the card (flash prefill,
    f32) as on the CPU (plain version), from the same weights."""
    import numpy as np

    from paddle_tpu_torch.core.config import flags, set_flags
    from paddle_tpu_torch.models import get_model, transformer_lm

    kw = dict(seq_len=64, vocab=64, d_model=64, d_inner=128, num_heads=2, n_layers=2)
    spec = get_model("transformer_lm", device="cpu", **kw)
    rng = np.random.RandomState(0)
    params = spec.model.init(0, *spec.synth_batch(2, rng), device="cpu").params
    prompt = torch.from_numpy(rng.randint(1, 64, size=(2, 64)).astype(np.int32))
    saved = flags().use_flash_attention
    set_flags(use_flash_attention=True)
    try:
        cpu = transformer_lm.generate(params, prompt, 4, spec.extra["cfg"], device="cpu")
        before = tfa.FLASH_FWD.launches
        gpu = transformer_lm.generate({n: p.to(cuda) for n, p in params.items()}, prompt, 4,
                                      spec.extra["cfg"])
        assert tfa.FLASH_FWD.launches == before + kw["n_layers"]
    finally:
        set_flags(use_flash_attention=saved)
    assert torch.equal(gpu.cpu(), cpu)


BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_flash_bwd_kernels_match_plain(cuda, case):
    """dK/dV and dQ kernels against their plain versions on the forward's
    cases (every case keeps a live key in every row). Each kernel counts one
    launch."""
    name, B, H, H_kv, T, T_kv, d, dtype, kw = case
    kw = dict(kw)
    q, k, v = _qkv(cuda, B, H, H_kv, T, d, dtype, T_kv)
    g = _qkv(cuda, B, H, H, T, d, dtype, seed=1)[0]
    if "kv_len" in kw:
        kw["kv_len"] = torch.tensor(kw["kv_len"], dtype=torch.int32, device=cuda)
    out, lse = tfa.flash_attention_with_lse(q, k, v, **kw)
    before = (tfa.FLASH_BWD_DKV.launches, tfa.FLASH_BWD_DQ.launches)
    dq, dk, dv = tfa.flash_attention_bwd_block(q, k, v, out, lse, g, **kw)
    torch.cuda.synchronize()
    assert (tfa.FLASH_BWD_DKV.launches, tfa.FLASH_BWD_DQ.launches) == (before[0] + 1, before[1] + 1)
    assert (dq.dtype, dk.dtype, dv.dtype) == (dtype,) * 3
    assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape
    delta = (g.float() * out.float()).sum(-1, keepdim=True)
    args = (q, k, v, g, lse, delta, kw.get("causal", False), 1.0 / d ** 0.5, kw.get("kv_len"),
            kw.get("window"), kw.get("q_off", 0), kw.get("k_off", 0))
    ref_dk, ref_dv = tfa._flash_bwd_dkv_reference(*args)
    ref_dq = tfa._flash_bwd_dq_reference(*args)
    for got, ref in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        assert bool(torch.isfinite(got).all())
        err = float((got.float() - ref.float()).abs().max() / ref.float().abs().max())
        assert err <= BWD_TOL[dtype], err


def test_flash_autograd_on_cuda_matches_cpu(cuda):
    """``flash_attention``'s autograd on the card (forward and both backward
    kernels, f32) gives the CPU's gradients (plain versions), fused and
    recomputed."""
    from paddle_tpu_torch.core.config import flags, set_flags

    q, k, v = _qkv(cuda, 2, 4, 2, 96, 64, torch.float32)
    g = _qkv(cuda, 2, 4, 4, 96, 64, torch.float32, seed=2)[0]
    saved = flags().flash_fused_bwd
    try:
        for fused in (True, False):
            set_flags(flash_fused_bwd=fused)
            grads = []
            for dev in (cuda, torch.device("cpu")):
                prim = [t.detach().to(dev).requires_grad_() for t in (q, k, v)]
                out = tfa.flash_attention(*prim, causal=True, window=40)
                grads.append(torch.autograd.grad(out, prim, g.to(dev)))
            for a, b in zip(*grads):
                torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-4)
    finally:
        set_flags(flash_fused_bwd=saved)


def test_train_step_on_cuda_matches_cpu(cuda):
    """Two Adam steps of the tiny LM on the card (flash forward and backward
    kernels, f32) against the same steps on the CPU (plain versions), from
    the same weights: losses and parameters within 1e-4. The k projections'
    biases have zero gradient in exact arithmetic (softmax shift
    invariance), and Adam's m / sqrt(v) divides out the scale of that
    rounding noise, so they are held only to the 2 * lr a two-step run can
    move them."""
    import numpy as np

    from paddle_tpu_torch.core.config import flags, set_flags
    from paddle_tpu_torch.framework import Variables
    from paddle_tpu_torch.models import get_model

    kw = dict(seq_len=64, vocab=64, d_model=64, d_inner=128, num_heads=2, n_layers=2)
    spec = get_model("transformer_lm", device="cpu", **kw)
    ids, labels = spec.synth_batch(2, np.random.RandomState(0))
    params = spec.model.init(0, ids, labels, device="cpu").params
    saved = flags().use_flash_attention
    set_flags(use_flash_attention=True)
    try:
        results = []
        for dev in (cuda, torch.device("cpu")):
            opt = spec.optimizer()
            variables = Variables({n: p.to(dev) for n, p in params.items()}, {})
            state = opt.create_state(variables.params)
            step = opt.minimize(spec.model)
            before = tfa.FLASH_BWD_DQ.launches
            losses = []
            for _ in range(2):
                out = step(variables, state, ids.to(dev), labels.to(dev))
                variables, state = out.variables, out.opt_state
                losses.append(float(out.loss))
            if dev.type == "cuda":
                assert tfa.FLASH_BWD_DQ.launches == before + 2 * kw["n_layers"]
            results.append((losses, variables.params))
    finally:
        set_flags(use_flash_attention=saved)
    (l_gpu, p_gpu), (l_cpu, p_cpu) = results
    np.testing.assert_allclose(l_gpu, l_cpu, rtol=0, atol=1e-4)
    for n, p in p_cpu.items():
        atol = 2 * 1e-3 if n.endswith("self_attn/k/b") else 1e-4
        torch.testing.assert_close(p_gpu[n].cpu(), p, rtol=0, atol=atol)


# The tilings of the wgmma + TMA kernels (forward: 128-row q tiles of 128 keys,
# 64 at d=128; dK/dV: 128-key tiles stepping 64 q rows, the head dim split
# across two blocks at d=128; dQ: 128-row q tiles, one 64-row warpgroup each,
# of 64 keys at every d): T on and off the tile edges (T = 130: the last q
# tile holds two rows, whose lse and Delta do not start 16-byte aligned),
# every head dim, GQA, a window, ragged kv_len, one (B, H) = (1, 1) call and
# the block backward at q_off = 256. (case, B, H, H_kv, T, T_kv, d, kwargs)
TILING_CASES = [
    (f"t{t}_d{d}", 2, 4, 4, t, t, d, dict(causal=True)) for t in (192, 1000, 1024) for d in (32, 64, 128)
] + [
    ("t130_d64", 2, 4, 4, 130, 130, 64, dict(causal=True)),
    ("gqa_hkv2", 2, 8, 2, 1024, 1024, 64, dict(causal=True)),
    ("window200", 2, 4, 4, 1000, 1000, 64, dict(causal=True, window=200)),
    ("ragged_kv_len", 3, 4, 4, 1024, 1024, 64, dict(causal=True, kv_len=[1024, 1, 333])),
    ("b1h1", 1, 1, 1, 1000, 1000, 64, dict(causal=True)),
    ("block_q_off256", 2, 8, 2, 256, 512, 64, dict(causal=True, window=200, q_off=256)),
]


@pytest.mark.parametrize("case", TILING_CASES, ids=[c[0] for c in TILING_CASES])
def test_hopper_kernel_tilings_match_plain(cuda, case):
    """The bf16 forward, dK/dV and dQ kernels against their plain versions at
    chip_smoke.py's tolerances (every case keeps a live key in every row)."""
    name, B, H, H_kv, T, T_kv, d, kw = case
    kw = dict(kw)
    q, k, v = _qkv(cuda, B, H, H_kv, T, d, torch.bfloat16, T_kv)
    g = _qkv(cuda, B, H, H, T, d, torch.bfloat16, seed=1)[0]
    if "kv_len" in kw:
        kw["kv_len"] = torch.tensor(kw["kv_len"], dtype=torch.int32, device=cuda)
    out, lse = tfa.flash_attention_with_lse(q, k, v, **kw)
    dq, dk, dv = tfa.flash_attention_bwd_block(q, k, v, out, lse, g, **kw)
    torch.cuda.synchronize()
    args = (q, k, v, g, lse, (g.float() * out.float()).sum(-1, keepdim=True), True, 1.0 / d ** 0.5,
            kw.get("kv_len"), kw.get("window"), kw.get("q_off", 0), 0)
    ref, ref_lse = tfa._reference_attention_with_lse(q, k, v, True, 1.0 / d ** 0.5, kw.get("kv_len"),
                                                     kw.get("window"), kw.get("q_off", 0))
    tol, tol_lse = TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=tol)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=tol_lse)
    ref_dk, ref_dv = tfa._flash_bwd_dkv_reference(*args)
    ref_dq = tfa._flash_bwd_dq_reference(*args)
    for got, want in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        assert bool(torch.isfinite(got).all())
        err = float((got.float() - want.float()).abs().max() / want.float().abs().max())
        assert err <= BWD_TOL[torch.bfloat16], err


def test_device_prefetcher_on_cuda_bit_exact(cuda):
    import numpy as np

    from paddle_tpu_torch.reader import DevicePrefetcher

    rng = np.random.RandomState(0)
    batches = [(rng.randn(64, 1024).astype(np.float32),
                rng.randint(0, 32000, (64, 128)).astype(np.int32)) for _ in range(8)]
    got = []
    for x, ids in DevicePrefetcher(iter(batches), device=cuda, depth=3):
        assert x.is_cuda and ids.dtype == torch.int32
        got.append(((x * 2).cpu(), ids.cpu()))  # work on the consumer stream
    assert len(got) == len(batches)
    for (x2, ids), (x, i) in zip(got, batches):
        assert torch.equal(x2, torch.from_numpy(x) * 2)
        assert torch.equal(ids, torch.from_numpy(i))


def test_trainer_prefetch_on_cuda_matches_plain(cuda):
    import numpy as np

    from paddle_tpu_torch.core.config import set_flags
    from paddle_tpu_torch.models import get_model
    from paddle_tpu_torch.trainer import EndStepEvent, Trainer

    set_flags(use_flash_attention=True, use_bf16_compute=True)
    try:
        spec = get_model("transformer_lm", seq_len=256, n_layers=2)
        rng = np.random.RandomState(0)
        batches = [tuple(t.cpu().numpy() for t in spec.synth_batch(4, rng)) for _ in range(3)]
        init = spec.model.init(0, *spec.synth_batch(4, rng))

        def run(prefetch):
            t = Trainer(lambda: spec.model, spec.optimizer, prefetch=prefetch)
            t.variables, t.opt_state = init, t.optimizer.create_state(init.params)
            losses = []
            t.train(num_epochs=2, reader=lambda: iter(batches),
                    event_handler=lambda ev: losses.append(ev.metrics)
                    if isinstance(ev, EndStepEvent) else None)
            return losses

        plain, prefetched = run(False), run(True)
        assert len(plain) == 6 and plain == prefetched
    finally:
        set_flags(use_flash_attention=False, use_bf16_compute=False)


def _rel_l2(a, b):
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).norm() / b.norm())


def test_f32_matmul_runs_bf16_on_tensor_cores_with_f32_result(cuda):
    from paddle_tpu_torch.core.dtypes import f32_matmul

    g = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn(512, 256, generator=g, device=cuda).bfloat16().requires_grad_()
    b = torch.randn(256, 384, generator=g, device=cuda).bfloat16().requires_grad_()
    dc = torch.randn(512, 384, generator=g, device=cuda)
    out = f32_matmul(a, b)
    assert out.dtype == torch.float32 and out.shape == (512, 384)
    da, db = torch.autograd.grad(out, (a, b), dc)
    assert da.dtype == db.dtype == torch.bfloat16 and da.shape == a.shape and db.shape == b.shape
    # the f32 path: the same bf16 values multiplied in f32 (full f32 by default)
    af, bf = a.detach().float().requires_grad_(), b.detach().float().requires_grad_()
    ref = af @ bf
    rda, rdb = torch.autograd.grad(ref, (af, bf), dc)
    assert _rel_l2(out, ref) <= 1e-2
    assert _rel_l2(da, rda) <= 1e-2 and _rel_l2(db, rdb) <= 1e-2
    with pytest.raises(ValueError, match="2-D"):
        f32_matmul(a[None], b)


def test_f32_conv_with_default_tf32_flags_matches_cpu(cuda):
    from paddle_tpu_torch.core.config import flags
    from paddle_tpu_torch.ops import nn as tnn

    defaults = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    assert defaults == (False, True) and not flags().use_bf16_compute
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 28, 28, 64, generator=g)
    w = torch.randn(3, 3, 64, 96, generator=g) * 0.05
    dy = torch.randn(4, 14, 14, 96, generator=g)
    res = []
    for dev in (cuda, torch.device("cpu")):
        xs, ws = x.to(dev).requires_grad_(), w.to(dev).requires_grad_()
        y = tnn.conv2d(xs, ws, stride=2, padding=1)
        res.append((y, *torch.autograd.grad(y, (xs, ws), dy.to(dev))))
    for a, b in zip(*res):
        assert _rel_l2(a, b) <= 1e-5
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == defaults


def test_batch_norm_fused_on_cuda_matches_plain_cpu(cuda):
    from paddle_tpu_torch.ops import nn as tnn

    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 14, 14, 32, generator=g) * 2 + 1
    scale, bias = torch.randn(32, generator=g), torch.randn(32, generator=g)
    mm, mv = torch.zeros(32), torch.ones(32)
    dy = torch.randn(8, 14, 14, 32, generator=g)
    res = []
    for dev in (cuda, torch.device("cpu")):
        xs, ss = x.to(dev).requires_grad_(), scale.to(dev).requires_grad_()
        y, nm, nv, _, _ = tnn.batch_norm_train(xs, ss, bias.to(dev), mm.to(dev), mv.to(dev))
        assert nm.grad_fn is None and nv.grad_fn is None
        res.append((y, nm, nv, *torch.autograd.grad(y, (xs, ss), dy.to(dev))))
    for a, b in zip(*res):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)


def test_f32_bmm_tensor_cores_and_full_f32(cuda):
    """bf16 operands: tensor cores with an f32 result, forward and backward,
    against the f32 product of the same values; f32 operands: full f32
    even with PyTorch's TF32 switch on, against the CPU."""
    from paddle_tpu_torch.core.dtypes import f32_bmm

    g = torch.Generator(device=cuda).manual_seed(1)
    a = torch.randn(6, 96, 64, generator=g, device=cuda)
    b = torch.randn(6, 64, 80, generator=g, device=cuda)
    dc = torch.randn(6, 96, 80, generator=g, device=cuda)
    ab, bb = (t.bfloat16().requires_grad_() for t in (a, b))
    out = f32_bmm(ab, bb)
    assert out.dtype == torch.float32
    da, db = torch.autograd.grad(out, (ab, bb), dc)
    assert da.dtype == db.dtype == torch.bfloat16
    af, bf = (t.detach().float().requires_grad_() for t in (ab, bb))
    ref = torch.bmm(af, bf)
    rda, rdb = torch.autograd.grad(ref, (af, bf), dc)
    assert _rel_l2(out, ref) <= 1e-2 and _rel_l2(da, rda) <= 1e-2 and _rel_l2(db, rdb) <= 1e-2
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        a32, b32 = a.clone().requires_grad_(), b.clone().requires_grad_()
        out32 = f32_bmm(a32, b32)
        g32 = torch.autograd.grad(out32, (a32, b32), dc)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    ac, bc = a.cpu().requires_grad_(), b.cpu().requires_grad_()
    refc = torch.bmm(ac, bc)
    gc = torch.autograd.grad(refc, (ac, bc), dc.cpu())
    assert _rel_l2(out32.cpu(), refc) <= 1e-5
    assert all(_rel_l2(x.cpu(), y) <= 1e-5 for x, y in zip(g32, gc))
    with pytest.raises(ValueError, match="3-D"):
        f32_bmm(a[0], b[0])


@pytest.mark.parametrize("h_kv", [4, 2], ids=["mha", "gqa"])
def test_composed_attention_on_cuda_matches_cpu(cuda, h_kv):
    """f32 composed attention (an additive mask, so no flash) on the card
    against the CPU, with the TF32 switch on: 1e-5 relative L2 on the
    output and q/k/v gradients."""
    from paddle_tpu_torch.ops.attention import scaled_dot_product_attention as sdpa

    q, k, v = _qkv(cuda, 2, 4, h_kv, 64, 32, torch.float32, T_kv=48, seed=3)
    mask = torch.zeros(2, 1, 64, 48, device=cuda)
    mask[..., 40:] = -torch.inf
    g = torch.randn(2, 4, 64, 32, device=cuda)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        res = {}
        for dev in (cuda, torch.device("cpu")):
            qkv = [t.to(dev).requires_grad_() for t in (q, k, v)]
            out = sdpa(*qkv, mask=mask.to(dev))
            res[dev.type] = (out, *torch.autograd.grad(out, qkv, g.to(dev)))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    for x, y in zip(res["cuda"], res["cpu"]):
        assert _rel_l2(x.cpu(), y) <= 1e-5


def _model_on(name, dev, **kw):
    import numpy as np

    from paddle_tpu_torch.models import get_model

    spec = get_model(name, device=dev, **kw)
    batch = spec.synth_batch(3, np.random.RandomState(0))
    return spec, batch


@pytest.mark.parametrize("name,kw", [
    ("transformer", dict(seq_len=64, src_vocab=64, trg_vocab=64, d_model=64, d_inner=128,
                         num_heads=2, n_layers=2, attn_dropout=0.0, relu_dropout=0.0,
                         residual_dropout=0.0)),
    ("stacked_dynamic_lstm", dict(vocab_size=50, emb_dim=32, hidden_dim=32, stacked_num=2,
                                  seq_len=12)),
    ("machine_translation", dict(vocab_size=50, emb_dim=32, hidden_dim=32, seq_len=12)),
], ids=["transformer", "stacked_dynamic_lstm", "machine_translation"])
def test_sequence_model_on_cuda_matches_cpu(cuda, name, kw):
    """f32, flash on: the card's loss and every gradient against the CPU's
    (the flash kernels against their plain versions for the Transformer)."""
    from paddle_tpu_torch.backward import append_backward
    from paddle_tpu_torch.core.config import flags, set_flags

    saved = flags().use_flash_attention
    set_flags(use_flash_attention=True)
    try:
        spec_c, batch = _model_on(name, "cpu", **kw)
        params = spec_c.model.init(0, *batch, device="cpu").params
        loss_c, (g_c, _, _) = append_backward(spec_c.model, *batch)(params)
        spec_g, batch_g = _model_on(name, cuda, **kw)
        loss_g, (g_g, _, _) = append_backward(spec_g.model, *batch_g)(
            {n: p.to(cuda) for n, p in params.items()})
    finally:
        set_flags(use_flash_attention=saved)
    assert abs(float(loss_g) - float(loss_c)) <= 1e-5 * abs(float(loss_c))
    norms = {n: float(x.norm()) for n, x in g_c.items()}
    floor = 1e-2 * max(norms.values())
    for n, x in g_c.items():
        assert float((g_g[n].cpu() - x).norm()) / max(norms[n], floor) <= 1e-4, n


def test_beam_search_on_cuda_matches_cpu(cuda):
    from paddle_tpu_torch.models import get_model

    kw = dict(vocab_size=40, emb_dim=32, hidden_dim=32, seq_len=10)
    spec_c, batch = _model_on("machine_translation", "cpu", **kw)
    params = spec_c.model.init(0, *batch, device="cpu").params
    infer = get_model("machine_translation", device="cpu", **kw).extra["make_infer_model"](
        beam_size=3, max_len=6)
    (seq_c, sc_c), _ = infer.apply(params, batch[0], batch[1])
    (seq_g, sc_g), _ = infer.apply({n: p.to(cuda) for n, p in params.items()},
                                   batch[0].to(cuda), batch[1].to(cuda))
    assert torch.equal(seq_g.cpu(), seq_c)
    assert float((sc_g.cpu() - sc_c).abs().max()) <= 1e-4


def _tiny_lm(**extra):
    import numpy as np

    from paddle_tpu_torch.models import get_model

    # head dim 32: the flash kernel's smallest
    kw = dict(seq_len=64, vocab=64, d_model=128, d_inner=128, num_heads=4, n_layers=2, **extra)
    spec = get_model("transformer_lm", device="cpu", **kw)
    rng = np.random.RandomState(0)
    params = spec.model.init(0, *spec.synth_batch(2, rng), device="cpu").params
    return spec.extra["cfg"], params, rng


@pytest.mark.parametrize("extra", [{}, dict(num_kv_heads=2, pos_encoding="rope", attention_window=9)],
                         ids=["base", "gqa_rope_window"])
def test_paged_decode_step_on_cuda_matches_cpu(cuda, extra):
    """The decode engine's step (``PagedDecoder.decode_step``, f32 pages,
    composed attention in full f32) on the card against the same step on
    the CPU: logits and every written page within 1e-4 (f32 sums in
    another order through two layers), and the same scratch-page
    discipline (idle slots at position 0 on page 0)."""
    import numpy as np

    from paddle_tpu_torch.models import transformer_lm as tlm

    cfg, params, rng = _tiny_lm(**extra)
    shape = tlm.paged_cache_shape(cfg, 24, 4)
    g = torch.Generator().manual_seed(0)
    k, v = torch.randn(*shape, generator=g), torch.randn(*shape, generator=g)
    tables = torch.from_numpy(np.array([[3, 7, 1, 9, 2, 5], [0] * 6, [13, 14, 15, 16, 17, 18]],
                                       np.int32))
    tokens = torch.from_numpy(rng.randint(1, 64, size=(3,)).astype(np.int32))
    pos = torch.tensor([13, 0, 22], dtype=torch.int32)
    outs = {}
    for dev in ("cpu", cuda):
        dec = tlm.PagedDecoder({n: p.to(dev) for n, p in params.items()}, cfg, 4, 6)
        kd, vd = k.to(dev), v.to(dev)
        with torch.no_grad():
            logits = dec.decode_step(tokens.to(dev), pos.to(dev), tables.to(dev), kd, vd)
        outs[str(dev)] = (logits.cpu(), kd.cpu(), vd.cpu())
    (lc, kc, vc), (lg, kg, vg) = outs["cpu"], outs[str(cuda)]
    assert float((lg - lc).abs().max()) <= 1e-4
    live = [p for p in range(1, 24)]  # page 0 takes the idle slot's garbage
    assert float((kg[:, live] - kc[:, live]).abs().max()) <= 1e-4
    assert float((vg[:, live] - vc[:, live]).abs().max()) <= 1e-4
    assert torch.equal(torch.argmax(lg, -1)[[0, 2]], torch.argmax(lc, -1)[[0, 2]])


def test_decode_engine_on_cuda_matches_generate(cuda):
    """The engine on the card (continuous batching through a starved page
    pool, so requests are preempted and resumed, and speculative
    self-draft) gives the card's own ``generate()`` tokens."""
    import numpy as np

    from paddle_tpu_torch.models import transformer_lm as tlm
    from paddle_tpu_torch.serving import DecodeConfig, DecodeEngine

    cfg, params, rng = _tiny_lm()
    params = {n: p.to(cuda) for n, p in params.items()}
    cases = [(rng.randint(1, 64, size=(tp,)).astype(np.int32), n)
             for tp, n in ((5, 20), (9, 14), (11, 23), (5, 12))]
    refs = [tlm.generate(params, torch.from_numpy(p[None]), n, cfg)[0].cpu().numpy()
            for p, n in cases]
    for spec in (False, True):
        engine = DecodeEngine(
            params, cfg, decode=DecodeConfig(max_slots=3, page_size=4, max_context=40,
                                             prefill_chunk=8, num_pages=14, spec_tokens=3),
            draft_variables=params if spec else None)
        try:
            assert engine.device.type == "cuda" and engine._k_pages.is_cuda
            outs = [h.result(timeout=120) for h in [engine.submit(p, n) for p, n in cases]]
            for ref, out in zip(refs, outs):
                np.testing.assert_array_equal(out.tokens, ref)
            assert engine.metrics.snapshot()["preempted_total"] >= 1
            assert engine.decode_step_cache_size() == 1
        finally:
            assert engine.close(timeout=120) == []
        engine.kv.assert_no_leaks()


def test_generate_beam_on_cuda_matches_cpu(cuda):
    """``generate_beam`` with the flash prefill on the card (one forward
    launch per layer, f32) against the CPU's plain version: the same
    beams, scores within 1e-4."""
    import numpy as np

    from paddle_tpu_torch.core.config import flags, set_flags
    from paddle_tpu_torch.models import transformer_lm as tlm

    cfg, params, rng = _tiny_lm()
    prompt = torch.from_numpy(rng.randint(2, 64, size=(2, 33)).astype(np.int32))
    saved = flags().use_flash_attention
    set_flags(use_flash_attention=True)
    try:
        seq_c, sc_c = tlm.generate_beam(params, prompt, 6, cfg, beam_size=3, device="cpu")
        before = tfa.FLASH_FWD.launches
        seq_g, sc_g = tlm.generate_beam({n: p.to(cuda) for n, p in params.items()}, prompt, 6,
                                        cfg, beam_size=3)
        assert tfa.FLASH_FWD.launches == before + cfg["n_layers"]
    finally:
        set_flags(use_flash_attention=saved)
    assert torch.equal(seq_g.cpu(), seq_c)
    assert float((sc_g.cpu() - sc_c).abs().max()) <= 1e-4
