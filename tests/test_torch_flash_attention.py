"""The port's flash attention (paddle_tpu_torch/ops/flash_attention.py)
against the JAX package's.

On the CPU the port's wrapper computes its plain version, which is held
here against the Pallas kernel run in interpret mode (the real kernel
body, as tests/test_pallas_interpret.py runs it) and against
``_plain_attention`` at ragged shapes. The kernel's TF32 arithmetic is
emulated on the CPU (``emulated_attention``) and held against
``_plain_attention`` too.

The backward's plain version ``plain_attention_bwd`` is held against the
JAX package's ``_fa_bwd`` behind the Pallas forward in interpret mode (as
tests/test_pallas_interpret.py::test_flash_custom_vjp_grads drives it),
key-bias cotangent included, at atol 5e-5 (that test allows 5e-4; the
largest error measured here is 7.6e-6), and against torch autograd of ``plain_attention`` at ragged
shapes within 1e-5 of each gradient's largest magnitude (at least 1; the
same products in another order). The backward kernels' tensor-core
arithmetic (3xTF32 for fp32; bf16 operands with P and dSoft rounded to
bf16) is emulated on the CPU (``emulated_attention_bwd``) and held against
``_fa_bwd`` and ``plain_attention_bwd`` the same way.

The CUDA kernels run only on a card: their cases are marked ``cuda`` and
skip elsewhere; chip_smoke.py holds them against the plain versions at
the model path's shapes.
"""

import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import pallas_attention as pa
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import flash_attention as fa


def _qkv(b, h, tq, tk, d, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, tq, d).astype("float32"),
            rng.randn(b, h, tk, d).astype("float32"),
            rng.randn(b, h, tk, d).astype("float32"))


def _key_bias(b, tk, lens):
    kb = np.zeros((b, tk), np.float32)
    for i, n in enumerate(lens):
        kb[i, n:] = -1e9
    return kb


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _ref_lse(q, k, kb, causal, scale):
    """float64 logsumexp of the masked scores."""
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64),
                  k.astype(np.float64)) * scale
    if kb is not None:
        s = s + kb[:, None, None, :]
    if causal:
        tq, tk = s.shape[-2:]
        s = np.where(np.tril(np.ones((tq, tk), bool), tk - tq), s, -1e30)
    m = s.max(-1, keepdims=True)
    return (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]


@pytest.mark.parametrize("b,h,t,causal,tail", [
    (1, 2, 256, False, None),
    (1, 2, 256, True, None),
    (2, 2, 128, False, 100),
], ids=["noncausal", "causal", "key_bias_tail"])
def test_plain_matches_pallas_kernel_in_interpret_mode(monkeypatch, b, h, t,
                                                        causal, tail):
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("PADDLE_TPU_FLASH_MIN_TK", "128")
    q, k, v = _qkv(b, h, t, t, 64, seed=t + int(causal))
    kb = None if tail is None else _key_bias(b, t, [tail] * b)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    assert pa._supported(jq, jk)  # the Pallas body really runs
    out, lse = pa._flash_fwd(jq, jk, jv, None if kb is None else
                             jnp.asarray(kb), causal, 0.125)
    pout, plse = fa.plain_attention(*_torch(q, k, v, kb), causal, 0.125)
    np.testing.assert_allclose(pout.numpy(), np.asarray(out), atol=2e-5)
    np.testing.assert_allclose(plse.numpy(), np.asarray(lse), atol=1e-5)


@pytest.mark.parametrize("b,h,tq,tk,d,causal,lens", [
    (2, 3, 77, 77, 48, True, [77, 50]),
    (2, 3, 77, 77, 48, False, [60, 77]),
    (2, 2, 100, 300, 64, False, [300, 123]),
    (2, 2, 100, 300, 64, True, [300, 250]),
    (2, 2, 300, 100, 64, True, None),
    (1, 2, 40, 40, 128, False, [17]),
], ids=["T77_D48_causal", "T77_D48", "Tq100_Tk300", "Tq100_Tk300_causal",
        "Tq300_Tk100_causal", "D128"])
def test_plain_matches_jax_plain_at_ragged_shapes(b, h, tq, tk, d, causal,
                                                  lens):
    q, k, v = _qkv(b, h, tq, tk, d, seed=tq + tk + d)
    kb = None if lens is None else _key_bias(b, tk, lens)
    scale = d ** -0.5
    ref = pa._plain_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              None if kb is None else jnp.asarray(kb),
                              causal, scale)
    out, lse = fa.plain_attention(*_torch(q, k, v, kb), causal, scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), _ref_lse(q, k, kb, causal, scale),
                               rtol=1e-6, atol=1e-5)


def _jax_plain(q, k, v, kb, causal, scale):
    return np.asarray(pa._plain_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if kb is None else jnp.asarray(kb), causal, scale))


@pytest.mark.parametrize("causal", [False, True], ids=["noncausal", "causal"])
@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5),
                                        ("bfloat16", 2e-2)])
def test_emulated_tf32_kernel_arithmetic_matches_jax_plain(dtype, atol,
                                                           causal):
    """The kernel's products (TF32 mma.sync: 3 split products for fp32
    inputs, 1 for bf16 inputs with P rounded to TF32) at the model's
    head shape against _plain_attention on the same values in fp32."""
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(dt)
               for a in _qkv(2, 8, 256, 256, 64, seed=17 + int(causal)))
    kb = _key_bias(2, 256, [256, 141])
    scale = 64 ** -0.5
    out, lse = fa.emulated_attention(q, k, v, torch.from_numpy(kb), causal,
                                     scale)
    assert out.dtype == dt
    qf, kf, vf = (a.float().numpy() for a in (q, k, v))
    ref = _jax_plain(qf, kf, vf, kb, causal, scale)
    np.testing.assert_allclose(out.float().numpy(), ref, atol=atol)
    np.testing.assert_allclose(lse.numpy(), _ref_lse(qf, kf, kb, causal,
                                                     scale), atol=1e-5)


@pytest.mark.parametrize("causal", [False, True], ids=["noncausal", "causal"])
def test_one_tf32_product_misses_the_fp32_tolerance(causal):
    """Why the kernel splits fp32 operands: one TF32 product per operand
    pair misses the card's fp32 tolerance of 1e-4, three meet it."""
    q, k, v = _qkv(2, 8, 256, 256, 64, seed=17 + int(causal))
    kb = _key_bias(2, 256, [256, 141])
    scale = 64 ** -0.5
    ref = _jax_plain(q, k, v, kb, causal, scale)
    err = {n: np.abs(fa.emulated_attention(*_torch(q, k, v, kb), causal,
                                           scale, products=n)[0].numpy()
                     - ref).max() for n in (1, 3)}
    assert err[1] > 1e-4 > 1e-5 > err[3]


@pytest.mark.parametrize("x,want", [
    (1.0, 1.0),
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),        # a tie rounds away
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (1.0 + 2.0 ** -12, 1.0),                     # below the tie
    (1.0 + 3 * 2.0 ** -12, 1.0 + 2.0 ** -10),
], ids=["exact", "tie_up", "tie_negative", "below_tie", "above_tie"])
def test_tf32_round_is_round_to_nearest_away(x, want):
    got = fa.tf32_round(torch.tensor([x], dtype=torch.float32))
    assert got.item() == want


def test_causal_alignment_is_bottom_right():
    """Tq != Tk causal: query r sees keys c <= r + Tk - Tq, the alignment
    of _plain_attention (pallas_attention.py:37), not the Pallas body's
    top-left rows >= cols (:71-75)."""
    tq, tk = 4, 10
    q, k, v = _qkv(1, 1, tq, tk, 8, seed=5)
    out, _ = fa.plain_attention(*_torch(q, k, v), None, True, 0.5)
    for r in range(tq):
        visible = r + tk - tq + 1
        s = q[0, 0, r] @ k[0, 0, :visible].T * 0.5
        p = np.exp(s - s.max())
        want = (p / p.sum()) @ v[0, 0, :visible]
        np.testing.assert_allclose(out[0, 0, r].numpy(), want, atol=1e-5)
    top_left, _ = fa.plain_attention(*_torch(q, k[..., :tq, :], v[..., :tq, :]),
                                     None, True, 0.5)
    assert not np.allclose(out[0, 0, 0].numpy(), top_left[0, 0, 0].numpy())


@pytest.mark.parametrize("causal", [False, True], ids=["noncausal", "causal"])
def test_fully_masked_row_is_uniform_like_jax(causal):
    """A batch row whose keys are all masked by the -1e9 bias attends
    uniformly (over its causally visible keys), in both packages."""
    q, k, v = _qkv(2, 2, 16, 16, 8, seed=9)
    kb = _key_bias(2, 16, [0, 16])
    out, lse = fa.plain_attention(*_torch(q, k, v, kb), causal, 0.3)
    ref = pa._plain_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(kb), causal, 0.3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)
    counts = np.arange(1, 17)[:, None] if causal else 16
    uniform = (np.cumsum(v[0], axis=1) / counts if causal
               else np.broadcast_to(v[0].mean(1, keepdims=True), v[0].shape))
    np.testing.assert_allclose(out[0].numpy(), uniform, atol=1e-5)
    assert np.all(lse[0].numpy() < -1e8)


def test_wrapper_on_cpu_tensors_is_the_plain_version():
    q, k, v = _qkv(2, 2, 33, 33, 16, seed=1)
    kb = _key_bias(2, 33, [20, 33])
    before = fa.launches
    out, lse = fa.flash_attention_fwd(*_torch(q, k, v, kb), True, 0.25)
    ref, ref_lse = fa.plain_attention(*_torch(q, k, v, kb), True, 0.25)
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)
    assert fa.launches == before  # no kernel launch counted on the CPU


def test_wrapper_does_not_fall_back_for_other_devices():
    """Only a CPU tensor takes the plain version; anything else must
    reach the kernel's checks (and here raises)."""
    q = torch.empty(1, 1, 8, 8, device="meta")
    with pytest.raises(ValueError, match="neither on the CPU nor on a CUDA"):
        fa.flash_attention_fwd(q, q, q, None, False, 1.0)


@pytest.mark.parametrize("shape,match", [
    ((1, 1, 64 * 65535 + 1, 8), "query tiles"),
    ((70000, 1, 8, 8), "neither on the CPU nor on a CUDA"),
], ids=["too_many_query_tiles", "bh_past_65535"])
def test_wrapper_checks_the_kernel_grid_limits(shape, match):
    """The kernel's grid is (B*H, ceil(Tq / 64)), capped at 2^31 - 1 and
    65535: Tq past 65535 query tiles is refused by the shape checks, B*H
    past 65535 passes them (and on a meta tensor stops at the device
    check). Meta tensors hold no memory."""
    q = torch.empty(shape, device="meta")
    with pytest.raises(ValueError, match=match):
        fa.flash_attention_fwd(q, q, q, None, False, 1.0)


def test_build_names_library_by_source_hash(tmp_path, monkeypatch):
    """A library is named by a hash of its source and of every header in
    csrc/, so an edit to the shared header builds both kernels anew."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    path = _build.library_path("flash_attention_fwd")
    assert path.startswith(str(tmp_path / "build"))
    assert path.endswith(".so") and "libflash_attention_fwd-" in path
    assert set(_build.SOURCES) == {"flash_attention_fwd",
                                   "flash_attention_bwd"}
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    before = {n: _build.library_path(n) for n in _build.SOURCES}
    assert before["flash_attention_fwd"] == path  # same files, same name
    header = csrc / "tensor_core.cuh"
    assert header.exists()
    for src in _build.SOURCES.values():
        assert '#include "tensor_core.cuh"' in (csrc / src).read_text()
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build.library_path(n) for n in _build.SOURCES}
    assert all(after[n] != before[n] for n in _build.SOURCES)
    (csrc / "flash_attention_bwd.cu").write_text(
        (csrc / "flash_attention_bwd.cu").read_text() + "\n")
    assert _build.library_path("flash_attention_bwd") != after[
        "flash_attention_bwd"]
    assert _build.library_path("flash_attention_fwd") == after[
        "flash_attention_fwd"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dt = getattr(torch, dtype)
    atol = 1e-4 if dt == torch.float32 else 2e-2
    for (b, h, tq, tk, d, causal) in [(2, 2, 256, 256, 64, False),
                                      (2, 2, 256, 256, 64, True),
                                      (1, 3, 77, 77, 48, True),
                                      (1, 2, 100, 300, 64, False),
                                      (1, 2, 100, 65, 32, False),
                                      (1, 2, 300, 300, 80, True),
                                      (1, 2, 90, 90, 33, True)]:
        q, k, v = (torch.from_numpy(a).cuda().to(dt)
                   for a in _qkv(b, h, tq, tk, d, seed=d))
        kb = torch.from_numpy(_key_bias(b, tk, [tk // 2] + [tk] * (b - 1)))
        kb = kb.cuda()
        out, lse = fa.flash_attention_fwd(q, k, v, kb, causal, d ** -0.5)
        ref, ref_lse = fa.plain_attention(q.float(), k.float(), v.float(),
                                          kb, causal, d ** -0.5)
        torch.cuda.synchronize()
        assert (out.float() - ref).abs().max().item() <= atol
        assert ((lse - ref_lse).abs() - 1e-6 * ref_lse.abs()).max() <= 1e-3


def _jax_flash_vjp(q, k, v, kb, do, causal, scale):
    """dq, dk, dv, dkb of the JAX package's flash_attention (custom_vjp:
    Pallas forward, _fa_bwd backward)."""
    import jax
    args = [jnp.asarray(a) for a in (q, k, v)]
    if kb is None:
        _, vjp = jax.vjp(lambda a, b, c: pa.flash_attention(
            a, b, c, causal, scale), *args)
        return [np.asarray(g) for g in vjp(jnp.asarray(do))] + [None]
    _, vjp = jax.vjp(lambda a, b, c, d: pa.flash_attention(
        a, b, c, causal, scale, key_bias=d), *args, jnp.asarray(kb))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("b,h,t,causal,tail", [
    (1, 2, 128, False, None),
    (1, 2, 256, True, None),
    (2, 2, 128, False, 100),
    (2, 2, 256, True, 200),
], ids=["noncausal", "causal", "key_bias_tail", "causal_key_bias_tail"])
def test_plain_bwd_matches_jax_fa_bwd(monkeypatch, b, h, t, causal, tail):
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("PADDLE_TPU_FLASH_MIN_TK", "128")
    q, k, v = _qkv(b, h, t, t, 64, seed=3 * t + int(causal))
    do = np.random.RandomState(t).randn(b, h, t, 64).astype(np.float32)
    kb = None if tail is None else _key_bias(b, t, [tail] + [t] * (b - 1))
    assert pa._supported(jnp.asarray(q), jnp.asarray(k))  # Pallas runs
    want = _jax_flash_vjp(q, k, v, kb, do, causal, 0.125)
    tq, tk, tv, tkb, tdo = _torch(q, k, v, kb, do)
    out, lse = fa.plain_attention(tq, tk, tv, tkb, causal, 0.125)
    got = fa.plain_attention_bwd(tq, tk, tv, tkb, out, lse, tdo, causal,
                                 0.125)
    for name, w, g in zip(("dq", "dk", "dv", "dkey_bias"), want, got):
        if w is None:
            assert g is None
            continue
        np.testing.assert_allclose(g.numpy(), w, atol=5e-5, rtol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("b,h,tq,tk,d,causal,lens", [
    (2, 3, 77, 77, 48, True, [77, 50]),
    (2, 2, 100, 300, 64, False, [300, 123]),
    (2, 2, 100, 300, 64, True, [300, 250]),
    (1, 2, 65, 129, 32, False, None),
    (2, 2, 40, 40, 128, True, [40, 1]),
], ids=["ragged_causal", "tq_lt_tk", "tq_lt_tk_causal", "no_bias", "d128"])
def test_plain_bwd_matches_torch_autograd(b, h, tq, tk, d, causal, lens):
    q, k, v = _torch(*_qkv(b, h, tq, tk, d, seed=tq + tk + d))
    kb = None if lens is None else torch.from_numpy(_key_bias(b, tk, lens))
    do = torch.from_numpy(np.random.RandomState(d).randn(
        b, h, tq, d).astype(np.float32))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    if kb is not None:
        leaves.append(kb.clone().requires_grad_())
    out, lse = fa.plain_attention(*leaves[:3], leaves[3] if kb is not None
                                  else None, causal, d ** -0.5)
    want = torch.autograd.grad(out, leaves, do)
    got = fa.plain_attention_bwd(q, k, v, kb, out.detach(), lse.detach(), do,
                                 causal, d ** -0.5)
    for name, w, g in zip(("dq", "dk", "dv", "dkey_bias"), want, got):
        np.testing.assert_allclose(
            g.numpy(), w.numpy(), rtol=0,
            atol=1e-5 * max(1.0, w.abs().max().item()), err_msg=name)
    assert got[3] is None if kb is None else got[3].dtype == torch.float32


@pytest.mark.parametrize("b,h,t,causal,tail", [
    (1, 2, 128, False, None),
    (1, 2, 256, True, None),
    (2, 2, 128, False, 100),
    (2, 2, 256, True, 200),
], ids=["noncausal", "causal", "key_bias_tail", "causal_key_bias_tail"])
def test_emulated_bwd_matches_jax_fa_bwd(monkeypatch, b, h, t, causal, tail):
    """The backward kernels' 3xTF32 arithmetic (fp32 inputs) against the
    JAX package's _fa_bwd behind the Pallas forward in interpret mode, at
    the plain version's tolerance (atol 5e-5): three TF32 products leave
    about 2^-21 of each product, so the emulation sits within 3.4e-6 of
    the plain version's largest gradient (measured below)."""
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("PADDLE_TPU_FLASH_MIN_TK", "128")
    q, k, v = _qkv(b, h, t, t, 64, seed=3 * t + int(causal))
    do = np.random.RandomState(t).randn(b, h, t, 64).astype(np.float32)
    kb = None if tail is None else _key_bias(b, t, [tail] + [t] * (b - 1))
    assert pa._supported(jnp.asarray(q), jnp.asarray(k))  # Pallas runs
    want = _jax_flash_vjp(q, k, v, kb, do, causal, 0.125)
    tq, tk, tv, tkb, tdo = _torch(q, k, v, kb, do)
    out, lse = fa.plain_attention(tq, tk, tv, tkb, causal, 0.125)
    got = fa.emulated_attention_bwd(tq, tk, tv, tkb, out, lse, tdo, causal,
                                    0.125)
    for name, w, g in zip(("dq", "dk", "dv", "dkey_bias"), want, got):
        if w is None:
            assert g is None
            continue
        np.testing.assert_allclose(g.numpy(), w, atol=5e-5, rtol=1e-5,
                                   err_msg=name)


def _bwd_case(b, h, tq, tk, d, causal, lens, dtype):
    """Inputs in ``dtype``, the plain forward's out (rounded to ``dtype``)
    and lse, and the plain backward on the same values in fp32."""
    q, k, v = _qkv(b, h, tq, tk, d, seed=tq + tk + d)
    do = np.random.RandomState(d).randn(b, h, tq, d).astype(np.float32)
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in (q, k, v, do))
    kb = None if lens is None else torch.from_numpy(_key_bias(b, tk, lens))
    scale = d ** -0.5
    out, lse = fa.plain_attention(q.float(), k.float(), v.float(), kb, causal,
                                  scale)
    out = out.to(dtype)
    want = fa.plain_attention_bwd(q.float(), k.float(), v.float(), kb,
                                  out.float(), lse, do.float(), causal, scale)
    return (q, k, v, kb, out, lse, do, causal, scale), want


_BWD_CASES = [
    (2, 8, 256, 256, 64, False, [256, 141]),
    (2, 8, 256, 256, 64, True, [256, 141]),
    (2, 3, 77, 77, 48, True, [77, 50]),
    (2, 2, 100, 300, 64, False, [300, 123]),
    (2, 2, 100, 300, 64, True, [300, 250]),
    (2, 2, 300, 100, 64, True, None),
]
_BWD_IDS = ["model_shape", "model_shape_causal", "ragged_causal_d48",
            "tq_lt_tk", "tq_lt_tk_causal", "tq_gt_tk_causal_no_bias"]


@pytest.mark.parametrize("case", _BWD_CASES, ids=_BWD_IDS)
@pytest.mark.parametrize("dtype,rel", [("float32", 1e-5),
                                       ("bfloat16", 1e-2)])
def test_emulated_bwd_matches_plain_bwd(dtype, rel, case):
    """The backward kernels' arithmetic against plain_attention_bwd on the
    same values in fp32, relative to each gradient's largest magnitude.
    fp32 (3xTF32) within 1e-5: measured 3.4e-6 at most. bf16 within the
    card's tolerance, 1e-2: dQ, dK and dV come back in bf16 (half an ulp
    is 2^-9 of a value) and P and dSoft are rounded to bf16 before their
    products; measured 5.1e-3 at most. dKeyBias sums dSoft in fp32 and
    stays within 1e-4."""
    args, want = _bwd_case(*case, getattr(torch, dtype))
    got = fa.emulated_attention_bwd(*args)
    for name, g, w in zip(("dq", "dk", "dv", "dkey_bias"), got, want):
        if w is None:
            assert g is None
            continue
        assert g.dtype == (torch.float32 if name == "dkey_bias"
                           else getattr(torch, dtype))
        limit = (1e-4 if name == "dkey_bias" and dtype == "bfloat16"
                 else rel) * w.abs().max().item()
        err = (g.float() - w).abs().max().item()
        assert err <= limit, f"{name}: {err:.3e} > {limit:.3e}"


@pytest.mark.parametrize("causal", [False, True], ids=["noncausal", "causal"])
def test_one_tf32_product_misses_the_bwd_fp32_tolerance(causal):
    """Why the backward kernels split fp32 operands: one TF32 product per
    operand pair misses the card's fp32 tolerance (1e-4 of each
    gradient's largest magnitude; measured 8.4e-4 and 1.3e-3), three
    meet it with room (3.4e-6 at most)."""
    args, want = _bwd_case(*_BWD_CASES[int(causal)], torch.float32)
    err = {}
    for n in (1, 3):
        got = fa.emulated_attention_bwd(*args, products=n)
        err[n] = max(((g - w).abs().max() / w.abs().max()).item()
                     for g, w in zip(got, want))
    assert err[1] > 1e-4 > 1e-5 > err[3]


def test_flash_attention_function_under_torch_func():
    """The autograd.Function pair differentiates under torch.func.vjp as
    autograd differentiates the plain version."""
    q, k, v = _torch(*_qkv(2, 2, 33, 33, 16, seed=5))
    kb = torch.from_numpy(_key_bias(2, 33, [33, 20]))
    do = torch.from_numpy(np.random.RandomState(1).randn(
        2, 2, 33, 16).astype(np.float32))
    out, vjp = torch.func.vjp(lambda a, b, c, e: fa.flash_attention(
        a, b, c, e, True, 0.25), q, k, v, kb)
    got = vjp(do)
    leaves = [t.clone().requires_grad_() for t in (q, k, v, kb)]
    ref, _ = fa.plain_attention(*leaves, True, 0.25)
    want = torch.autograd.grad(ref, leaves, do)
    torch.testing.assert_close(out, ref.detach())
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5)


def test_bwd_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    q, k, v = _torch(*_qkv(1, 2, 20, 20, 8, seed=2))
    out, lse = fa.plain_attention(q, k, v, None, True, 0.3)
    before = fa.bwd_launches
    got = fa.flash_attention_bwd(q, k, v, None, out, lse, out, True, 0.3)
    want = fa.plain_attention_bwd(q, k, v, None, out, lse, out, True, 0.3)
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)
    assert fa.bwd_launches == before


def test_bwd_wrapper_does_not_fall_back_for_other_devices():
    q = torch.empty(1, 1, 8, 8, device="meta")
    lse = torch.empty(1, 1, 8, device="meta")
    with pytest.raises(ValueError, match="neither on the CPU nor on a CUDA"):
        fa.flash_attention_bwd(q, q, q, None, q, lse, q, False, 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_bwd_kernel_matches_plain(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    rel = 1e-4 if dt == torch.float32 else 2e-2
    for (b, h, tq, tk, d, causal) in [(2, 2, 256, 256, 64, False),
                                      (2, 2, 256, 256, 64, True),
                                      (1, 3, 77, 77, 48, True),
                                      (1, 2, 100, 300, 64, False),
                                      (1, 2, 100, 65, 32, False),
                                      (1, 2, 130, 130, 128, True)]:
        q, k, v = (torch.from_numpy(a).cuda().to(dt)
                   for a in _qkv(b, h, tq, tk, d, seed=d))
        do = torch.randn(b, h, tq, d, device="cuda").to(dt)
        kb = torch.from_numpy(_key_bias(b, tk, [tk // 2] + [tk] * (b - 1)))
        kb = kb.cuda()
        out, lse = fa.flash_attention_fwd(q, k, v, kb, causal, d ** -0.5)
        got = fa.flash_attention_bwd(q, k, v, kb, out, lse, do, causal,
                                     d ** -0.5)
        want = fa.plain_attention_bwd(q.float(), k.float(), v.float(), kb,
                                      out.float(), lse, do.float(), causal,
                                      d ** -0.5)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            err = (g.float() - w).abs().max().item()
            assert err <= rel * w.abs().max().item() + 1e-6
