"""Generation in the port against the JAX package's, on the CPU.

- **Programs.** ``build_lm``'s startup, prefill (each prompt bucket),
  prefix-prefill (each suffix bucket and prefix length) and decode (each
  cap) programs serialize to the JAX package's bytes, at a tiny size and
  at chip_smoke.py phase 14's widths (bench_transformer's: 6 layers,
  d_model 512, vocab 32000, 256 positions); so does
  ``multi_head_attention(cache=...)``'s step, whose output equals the
  full forward's last column.
- **Ops.** ``kv_cache_write``, ``kv_cache_gather_paged``,
  ``kv_cache_write_paged``, ``concat`` and
  ``fusion_transpose_flatten_concat`` equal the JAX package's bitwise on
  seeded inputs, at the edges tests/test_generation_paging.py pins
  (clamp at the cap, masked writes and positions past the table to the
  null page, the ``cap`` trim); the registered cache ops leave their
  inputs as they were.
- **Steps.** From the JAX engine's startup, carried over as numpy: one
  decode step's logits and caches, and a prefill's and a prefix
  prefill's logits and K/V, within 1e-5 of the largest magnitude (fp32
  products of other blockings on both sides).
- **Engines.** ``DecodeEngine.generate`` gives the JAX engine's greedy
  tokens, and the port's ``naive_generate``'s, dense, paged and paged
  with prefix reuse (the JAX fixture's LM, tests/test_generation.py).
  The JAX engine tests the port mirrors: EOS frees a slot, no new plan
  or decode build after warm traffic, the cache never read to the host,
  sampling knobs checked against the top-k window, a sampled request's
  tokens private to its seed across joins (the port's own stream),
  paged bitwise the dense engine, the paged table's shapes.
- **Sampling.** The port's counter-based stream: drawn frequencies on a
  small vocabulary within a binomial bound of the softmax (of the top-k
  renormalized softmax), the greedy-only head, private rows.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu import layers as jlayers
from paddle_tpu.executor import Scope as JScope
from paddle_tpu.framework import program_guard as jguard
from paddle_tpu.inference.generation import DecodeEngine as JEngine
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu.ops import kernels_cache as jcache
from paddle_tpu.ops import kernels_fused as jfused
from paddle_tpu.ops import kernels_tensor as jtensor
from paddle_tpu.utils import unique_name as junique
from paddle_tpu.utils.flags import FLAGS as JFLAGS

import paddle_tpu_torch as pt
from paddle_tpu_torch import layers as players
from paddle_tpu_torch.inference.generation import (DecodeEngine,
                                                   PagedSlotState,
                                                   SamplingParams,
                                                   naive_generate)
from paddle_tpu_torch.inference.generation import engine as pengine
from paddle_tpu_torch.inference.generation import sampling as psampling
from paddle_tpu_torch.models import transformer as ptransformer
from paddle_tpu_torch.ops import kernels_cache as pcache
from paddle_tpu_torch.ops import kernels_fused as pfused
from paddle_tpu_torch.ops import kernels_tensor as ptensor
from paddle_tpu_torch.registry import EmitContext
from paddle_tpu_torch.utils import unique_name as punique
from paddle_tpu_torch.utils.flags import FLAGS as PFLAGS

VOCAB = 64
EOS = 1
TINY = dict(vocab=VOCAB, n_layer=2, n_head=2, d_model=16, d_inner_hid=32,
            max_positions=64, eos_id=EOS)
BENCH = dict(vocab=32000, n_layer=6, n_head=8, d_model=512,
             d_inner_hid=2048, max_positions=256, eos_id=EOS)
ENGINE = dict(prompt_buckets=(8, 16), new_token_buckets=(8,),
              slot_buckets=(1, 2))
# fp32 products of other blockings on the two sides, a share of each
# output's largest magnitude
STEP_REL = 1e-5
CTX = EmitContext(torch.device("cpu"))


@pytest.fixture(autouse=True)
def _flags():
    names = ("op_callstack", "generation_paged", "generation_prefix_cache")
    old = [(f, n, getattr(f, n)) for f in (JFLAGS, PFLAGS) for n in names]
    JFLAGS.op_callstack = PFLAGS.op_callstack = False
    yield
    for f, n, v in old:
        setattr(f, n, v)


def _lms(cfg):
    with junique.guard():
        j = jtransformer.build_lm(**cfg)["spec"]
    with punique.guard():
        p = ptransformer.build_lm(**cfg)["spec"]
    return j, p


def _engines(paged, prefix=True, cfg=TINY, **kw):
    """A JAX and a port DecodeEngine on the CPU with the same weights (the
    JAX startup's, carried over as numpy)."""
    JFLAGS.generation_paged = PFLAGS.generation_paged = paged
    JFLAGS.generation_prefix_cache = PFLAGS.generation_prefix_cache = prefix
    jspec, pspec = _lms(cfg)
    jspec.startup.random_seed = 7
    args = dict(ENGINE, **kw)
    je = JEngine(jspec, place=fluid.CPUPlace(), scope=JScope(), **args)
    je.initialize()
    pe = DecodeEngine(pspec, place=pt.CPUPlace(), scope=pt.Scope(), **args)
    pe.initialize()
    names = [v.name for v in pspec.startup.list_vars() if v.persistable]
    pt.io.set_params_from_numpy(
        pe.scope, {n: np.asarray(je.scope.find_var(n)) for n in names},
        "cpu", program=pspec.startup)
    return je, pe


def _port_engine(paged, prefix=True, eos_id=EOS):
    """A port DecodeEngine alone, its weights from a seeded startup (the
    same in every engine made here)."""
    PFLAGS.generation_paged, PFLAGS.generation_prefix_cache = paged, prefix
    with punique.guard():
        spec = ptransformer.build_lm(**dict(TINY, eos_id=eos_id))["spec"]
    spec.startup.random_seed = 3
    return DecodeEngine(spec, place=pt.CPUPlace(), scope=pt.Scope(),
                        **ENGINE).initialize()


@pytest.fixture(scope="module")
def pair():
    """The dense pair, shared by the tests that need any engine."""
    old = PFLAGS.generation_paged, JFLAGS.generation_paged
    try:
        return _engines(paged=False)
    finally:
        PFLAGS.generation_paged, JFLAGS.generation_paged = old


def _prompts(lengths, seed=0, shared=0, every=2):
    """Seeded prompts; every ``every``-th opens with the same ``shared``
    tokens (at most its length - 1)."""
    rng = np.random.RandomState(seed)
    out = [rng.randint(2, VOCAB, (n,)).astype(np.int64) for n in lengths]
    sys_tokens = rng.randint(2, VOCAB, (max(shared, 1),))
    for p in out[::every]:
        k = min(shared, len(p) - 1)
        p[:k] = sys_tokens[:k]
    return out


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# ---------------------------------------------------------------------------
# programs
# ---------------------------------------------------------------------------

def _program_bytes(spec, guard, kind, cfg):
    tops = (8, 16) if cfg is TINY else (32, 64, 128)
    if kind == "startup":
        return [spec.startup.desc.to_bytes()]
    out = []
    for b in tops:
        with guard():
            if kind == "prefill":
                prog = spec.build_prefill(b)[0]
            elif kind == "decode":
                prog = spec.build_decode(b + tops[-1])[0]
            else:
                prog = spec.build_prefill_prefix(b, tops[-1] - 8)[0]
        out.append(prog.desc.to_bytes())
    return out


@pytest.mark.parametrize("kind", ["startup", "prefill", "prefix", "decode"])
@pytest.mark.parametrize("cfg", ["tiny", "bench"])
def test_lm_programs_bytes_identical(cfg, kind):
    cfg = TINY if cfg == "tiny" else BENCH
    jspec, pspec = _lms(cfg)
    assert _program_bytes(pspec, punique.guard, kind, cfg) == \
        _program_bytes(jspec, junique.guard, kind, cfg)


def _cache_step(mod, layers_mod, guard, program_guard, B, T, H, DK, DM):
    """tests/test_generation.py's cache step in either package: the full
    causal forward and the one-token step on a fed cache."""
    with guard():
        full, step, startup = mod.Program(), mod.Program(), mod.Program()
        tr = jtransformer if mod is fluid else ptransformer
        with program_guard(full, startup):
            x = layers_mod.data("x", shape=[T, DM], dtype="float32")
            out_full = tr.multi_head_attention(
                x, None, None, None, DK, DK, DM, n_head=H, causal=True,
                name="att", attention_impl="unfused")
        with program_guard(step, mod.Program()):
            x_last = layers_mod.data("x_last", shape=[1, DM],
                                     dtype="float32")
            ck = layers_mod.data("ck", shape=[H, T - 1, DK], dtype="float32")
            cv = layers_mod.data("cv", shape=[H, T - 1, DK], dtype="float32")
            cache = {"k": ck, "v": cv}
            out_step = tr.multi_head_attention(
                x_last, None, None, None, DK, DK, DM, n_head=H, cache=cache,
                name="att", attention_impl="unfused")
            assert cache["k"] is not ck and cache["v"] is not cv
    return full, step, startup, out_full, out_step, cache


def test_multi_head_attention_cache_matches_jax():
    """The cache path's programs are the JAX package's, and one cached
    step of the port equals its full forward's last column (the JAX
    test's rtol 2e-5, atol 2e-6)."""
    B, T, H, DK, DM = 2, 6, 2, 8, 16
    j = _cache_step(fluid, jlayers, junique.guard, jguard, B, T, H, DK, DM)
    p = _cache_step(pt, players, punique.guard, pt.program_guard, B, T, H,
                    DK, DM)
    for jp, pp in zip(j[:3], p[:3]):
        assert pp.desc.to_bytes() == jp.desc.to_bytes()
    full, step, startup, out_full, out_step, cache = p
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    xv = np.random.RandomState(3).randn(B, T, DM).astype(np.float32)
    (want,) = exe.run(full, feed={"x": xv}, fetch_list=[out_full],
                      scope=scope)

    def split_heads(a):
        return a.reshape(B, T - 1, H, DK).transpose(0, 2, 1, 3)

    wk, wv = (scope.find_var(n).numpy() for n in ("att_k.w", "att_v.w"))
    got, grown = exe.run(step, feed={
        "x_last": xv[:, T - 1:], "ck": split_heads(xv[:, :T - 1] @ wk),
        "cv": split_heads(xv[:, :T - 1] @ wv)},
        fetch_list=[out_step, cache["k"]], scope=scope)
    assert grown.shape == (B, H, T, DK)
    np.testing.assert_allclose(got[:, 0], want[:, -1], rtol=2e-5, atol=2e-6)


def test_cache_rejects_sp_attention_impls():
    """The sequence-parallel impls have no cache path (the JAX package
    raises ValueError); the port has no such impl at all (ROADMAP A12)."""
    with pt.program_guard(pt.Program(), pt.Program()):
        x = players.data("x", shape=[1, 16], dtype="float32")
        ck = players.data("ck", shape=[2, 3, 8], dtype="float32")
        with pytest.raises(NotImplementedError, match="A12"):
            ptransformer.multi_head_attention(
                x, None, None, None, 8, 8, 16, n_head=2,
                cache={"k": ck, "v": ck}, name="a", attention_impl="ring")


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

def _jnp(*arrays):
    import jax.numpy as jnp
    return [jnp.asarray(a) for a in arrays]


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("positions", [
    [0, 0, 0, 0],          # the first column
    [5, 0, 3, 5],          # cap - 1 among interior columns
    [6, 6, 0, 5],          # exactly cap: clamps to cap - 1
    [9, 100, 0, 6],        # far past cap
])
def test_kv_cache_write_dense_edges(positions):
    B, H, CAP, D = 4, 2, 6, 3
    rng = np.random.RandomState(7)
    cache = rng.randn(B, H, CAP, D).astype(np.float32)
    new = rng.randn(B, H, 1, D).astype(np.float32)
    for dtype in (np.int32, np.int64):
        pos = np.asarray(positions, dtype)
        jc, jn, jp = _jnp(cache, new, pos)
        want = np.asarray(jcache.kv_cache_write(
            None, {"Cache": [jc], "New": [jn], "Position": [jp]},
            {})["Out"][0])
        pc, pn, pp = _t(cache, new, pos)
        got = pcache.kv_cache_write(
            CTX, {"Cache": [pc], "New": [pn], "Position": [pp]}, {})["Out"][0]
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(pc.numpy(), cache)   # not mutated


def test_kv_cache_write_paged_edges():
    """Writes land through the table at the first and last column and at
    page boundaries; positions at or past the table's reach and masked
    slots go to the null page. Pages 1.. bitwise the JAX op's (the null
    page's content is unspecified where writes collide); the pool the op
    reads is left as it was."""
    P_TOT, H, PAGE, D, B, MP = 7, 2, 4, 3, 3, 2
    cap = MP * PAGE
    rng = np.random.RandomState(11)
    pool = rng.randn(P_TOT, H, PAGE, D).astype(np.float32)
    table = np.asarray([[1, 2], [3, 4], [5, 6]], np.int32)
    for positions, mask in [([0, 0, 0], None), ([cap - 1, 3, 4], None),
                            ([cap, cap + 9, 0], None),
                            ([1, 2, 3], [True, False, True])]:
        new = rng.randn(B, H, 1, D).astype(np.float32)
        pos = np.asarray(positions, np.int32)
        ins = {"Pool": pool, "Table": table, "New": new, "Position": pos}
        if mask is not None:
            ins["Mask"] = np.asarray(mask)
        want = np.asarray(jcache.kv_cache_write_paged(
            None, {k: _jnp(v) for k, v in ins.items()}, {})["Out"][0])
        pins = {k: _t(v) for k, v in ins.items()}
        got = pcache.kv_cache_write_paged(CTX, pins, {})["Out"][0].numpy()
        np.testing.assert_array_equal(got[1:], want[1:])
        np.testing.assert_array_equal(pins["Pool"][0].numpy(), pool)
        live = [b for b in range(B) if (mask is None or not mask[b])
                and positions[b] < cap]
        for b in live:   # the column landed where the table says
            pg = table[b, positions[b] // PAGE]
            np.testing.assert_array_equal(
                got[pg, :, positions[b] % PAGE], new[b, :, 0])


def test_paged_gather_matches_jax_and_trims():
    P_TOT, H, PAGE, D = 6, 2, 4, 3
    pool = np.random.RandomState(3).randn(P_TOT, H, PAGE, D).astype(
        np.float32)
    pool[0] = 0.0
    table = np.asarray([[2, 5], [4, 0]], np.int32)
    for cap in (0, 6, 8):
        want = np.asarray(jcache.kv_cache_gather_paged(
            None, {"Pool": _jnp(pool), "Table": _jnp(table)},
            {"cap": cap})["Out"][0])
        got = pcache.kv_cache_gather_paged(
            CTX, {"Pool": _t(pool), "Table": _t(table)},
            {"cap": cap})["Out"][0].numpy()
        np.testing.assert_array_equal(got, want)
        assert got.shape == (2, H, cap or 2 * PAGE, D)
    np.testing.assert_array_equal(got[0, :, :PAGE], pool[2])
    assert not got[1, :, PAGE:].any()


@pytest.mark.parametrize("axis", [0, 1, 2, -1])
def test_concat_matches_jax(axis):
    rng = np.random.RandomState(axis + 5)
    shapes = [[2, 3, 4], [2, 3, 4], [2, 3, 4]]
    shapes[1][axis] = 5
    xs = [rng.randn(*s).astype(np.float32) for s in shapes]
    want = np.asarray(jtensor.concat(None, {"X": _jnp(*xs)},
                                     {"axis": axis})["Out"][0])
    got = ptensor.concat(CTX, {"X": _t(*xs)}, {"axis": axis})["Out"][0]
    np.testing.assert_array_equal(got.numpy(), want)


def test_fusion_transpose_flatten_concat_matches_jax():
    rng = np.random.RandomState(2)
    xs = [rng.randn(2, 4, 3, 5).astype(np.float32),
          rng.randn(2, 6, 3, 5).astype(np.float32)]
    attrs = {"trans_axis": [0, 2, 3, 1], "flatten_axis": 1,
             "concat_axis": 1}
    want = np.asarray(jfused.fusion_transpose_flatten_concat(
        None, {"X": _jnp(*xs)}, attrs)["Out"][0])
    got = pfused.fusion_transpose_flatten_concat(CTX, {"X": _t(*xs)}, attrs)
    np.testing.assert_array_equal(got["Out"][0].numpy(), want)


# ---------------------------------------------------------------------------
# one step of each program, from the same weights
# ---------------------------------------------------------------------------

def _run_both(pair, build, feed):
    je, pe = pair
    with junique.guard():
        jprog, jio = build(je.spec)
    with punique.guard():
        pprog, pio = build(pe.spec)
    names = [jio["logits"]] + list(jio.get("k", jio.get("new_k"))) \
        + list(jio.get("v", jio.get("new_v")))
    with fluid.scope_guard(je.scope):
        jout = fluid.Executor(fluid.CPUPlace()).run(
            jprog, feed=feed, fetch_list=names)
    pout = pt.Executor(pt.CPUPlace()).run(pprog, feed=feed,
                                          fetch_list=names, scope=pe.scope)
    for n, j, p in zip(names, jout, pout):
        assert _rel(p, j) <= STEP_REL, n


def test_decode_step_matches_jax(pair):
    rng = np.random.RandomState(4)
    cap, n_layer, H, D = 24, 2, 2, 8
    feed = {"gen_token": rng.randint(2, VOCAB, (2, 1, 1)).astype(np.int64),
            "gen_pos": np.asarray([5, 23], np.int32)}
    for i in range(n_layer):
        for kv in "kv":
            feed[f"gen_cache_{kv}{i}"] = rng.randn(2, H, cap, D).astype(
                np.float32)
    _run_both(pair, lambda spec: spec.build_decode(cap), feed)


def test_prefill_and_prefix_prefill_match_jax(pair):
    rng = np.random.RandomState(5)
    tokens = rng.randint(2, VOCAB, (1, 16, 1)).astype(np.int64)
    _run_both(pair, lambda spec: spec.build_prefill(16), {
        "lm_tokens": tokens,
        "lm_pos": np.arange(16, dtype=np.int64).reshape(1, 16, 1),
        "lm_len": np.asarray([11], np.int32)})
    feed = {"lm_tokens": tokens[:, :8],
            "lm_pos": (5 + np.arange(8, dtype=np.int64)).reshape(1, 8, 1),
            "lm_len": np.asarray([6], np.int32),
            "lm_prefix_len": np.asarray([5], np.int32)}
    for i in range(2):
        for kv in "kv":
            feed[f"lm_prefix_{kv}{i}"] = rng.randn(1, 2, 8, 8).astype(
                np.float32)
    _run_both(pair, lambda spec: spec.build_prefill_prefix(8, 8), feed)


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["dense", "paged", "paged_prefix"])
def test_greedy_generate_matches_jax(mode):
    """Mixed lengths, each prompt opening with the same 16 tokens (at most
    its length - 1): the second prompt of a 2-slot chunk hits the first's
    pages on the paged engine with reuse."""
    je, pe = _engines(paged=mode != "dense", prefix=mode == "paged_prefix")
    prompts = _prompts([3, 8, 11, 16, 12, 13, 16, 9], seed=1, shared=16,
                       every=1)
    want = [o.tolist() for o in je.generate(prompts, 6)]
    got = [o.tolist() for o in pe.generate(prompts, 6)]
    assert got == want
    assert [naive_generate(pe, p, 6).tolist() for p in prompts] == want
    assert (pe.stats["prefix_hits"] > 0) == (mode == "paged_prefix")
    assert (pe.stats["prefill_tokens_saved"] > 0) == (mode == "paged_prefix")


def test_eos_frees_slot_early():
    """A sequence that emits EOS leaves: with the model's first greedy
    token as eos, the same prompt returns that one token."""
    prompt = _prompts([5])[0]
    first = int(_port_engine(True).generate([prompt], 4)[0][0])
    out = _port_engine(True, eos_id=first).generate([prompt], 4)[0]
    assert out.tolist() == [first]


def _counts(e):
    progs = list(e._prefill_progs.values()) + list(e._prefix_progs.values())
    return ({k: e.stats[k] for k in ("decode_builds", "ingest_builds",
                                     "carries")},
            sum(len(p.__dict__.get("_exec_cache", {})) for p, _ in progs))


@pytest.mark.parametrize("paged", [False, True])
def test_zero_post_warmup_retraces_mixed_lengths(paged):
    """After one pass over every (slots, prompt bucket) cell, traffic of
    mixed lengths makes no prefill plan, decode plan, ingest key or
    carry."""
    pe = _port_engine(paged)
    pe.generate(_prompts([3, 12]), 5)
    pe.generate(_prompts([9]), 5)
    st = pe.alloc_state(2, 24)
    pe.warm_prefix(st)
    pe.free_state(st)
    before = _counts(pe)
    for seed, lengths in enumerate(([3, 9], [15, 6], [12], [8, 16])):
        pe.generate(_prompts(lengths, seed=seed + 4, shared=9), 5)
    assert _counts(pe) == before


def test_kv_cache_never_crosses_host(pair):
    """A decode chunk reads only its tokens and done flags to the host; the
    caches stay the same tensors, updated in place."""
    _je, pe = pair
    st = pe.alloc_state(2, 24)
    pe.admit(st, 0, _prompts([6], seed=5)[0], 8)
    pe.admit(st, 1, _prompts([12], seed=6)[0], 8)
    tensors = [id(t) for t in st.pack()]
    fetched = pe.stats["host_fetch_bytes"]
    before = [t.clone() for t in st.cache_k]
    for _ in range(3):
        toks, dones = pe.decode_chunk(st, 2)
        assert toks.dtype == np.int32 and dones.dtype == np.bool_
        assert toks.shape == dones.shape == (2, 2)
    assert [id(t) for t in st.pack()] == tensors
    assert any(not torch.equal(a, b) for a, b in zip(before, st.cache_k))
    host = pe.stats["host_fetch_bytes"] - fetched
    assert host == 3 * 2 * 2 * (4 + 1)
    assert host <= st.cache_bytes() / 16
    pe.free_state(st)


def test_sampling_params_validated_against_compiled_window(pair):
    _je, pe = pair
    with pytest.raises(ValueError, match="top-k window"):
        pe.validate_sampling(SamplingParams(temperature=1.0, top_k=1000))
    pe.validate_sampling(SamplingParams(temperature=1.0, top_k=8))
    greedy_only = DecodeEngine.__new__(DecodeEngine)
    greedy_only.top_k_max = 0
    with pytest.raises(ValueError, match="greedy-only"):
        DecodeEngine.validate_sampling(greedy_only,
                                       SamplingParams(temperature=0.5))


def test_sampling_rng_carry_deterministic_across_joins(pair):
    """Same (seed, prompt): the same tokens alone in slot 0, in slot 1
    beside a sampled neighbour, and re-admitted to slot 1 after another
    request left it mid-decode; another seed gives other tokens."""
    _je, pe = pair
    sp = SamplingParams(temperature=1.0, top_k=8, seed=42)
    prompt, other = _prompts([7, 9], seed=2)

    def run(slot, setup=None, sampling=sp, steps=8):
        st = pe.alloc_state(2, 24)
        if setup:
            setup(st)
        pe.admit(st, slot, prompt, steps, sampling)
        toks, dones = pe.decode_chunk(st, steps)
        pe.free_state(st)
        return pengine.collect_tokens(toks[:, slot], dones[:, slot], steps)

    def neighbour(st):
        pe.admit(st, 0, other, 8, SamplingParams(temperature=1.0, seed=9))

    def leave(st):
        neighbour(st)
        pe.admit(st, 1, other, 8, SamplingParams(temperature=0.7, seed=1))
        pe.decode_chunk(st, 3)
        pe.release_slot(st, 1)

    solo = run(0).tolist()
    assert run(1, neighbour).tolist() == solo
    assert run(1, leave).tolist() == solo
    assert run(0, sampling=SamplingParams(
        temperature=1.0, top_k=8, seed=43)).tolist() != solo


def test_paged_one_shot_bitexact_vs_dense():
    """The paged engine's greedy tokens and carry logits are the dense
    engine's, bitwise (null pages and stale pages are masked)."""
    paged = _port_engine(True, prefix=False)
    dense = _port_engine(False)
    prompts = _prompts([3, 8, 11, 16], seed=5)
    assert [o.tolist() for o in paged.generate(prompts, 6)] == \
        [o.tolist() for o in dense.generate(prompts, 6)]
    logits = []
    for e in (dense, paged):
        st = e.alloc_state(2, 24)
        e.admit(st, 0, prompts[1], 8)
        e.admit(st, 1, prompts[3], 8)
        e.decode_chunk(st, 5)
        logits.append(st.logits.clone())
    assert torch.equal(*logits)


def test_paged_state_shapes_and_residency():
    pe = _port_engine(True)
    st = pe.alloc_state(2, 24)
    assert isinstance(st, PagedSlotState)
    assert st.num_pages == pe.default_num_pages(2, 24)
    assert st.max_pages == 3 and st.table.shape == (2, 3)
    assert st.table.dtype == torch.int32
    assert st.cache_k[0].shape == (st.num_pages + 1, 2, pe.page_size, 8)
    assert st.cache_bytes() == pe.state_nbytes(2, 24) - 2 * (
        VOCAB * 4 + pengine._CARRY_BYTES_PER_SLOT)
    assert st.alloc.num_pages == st.num_pages
    assert st.page_nbytes() == pe.page_nbytes()


def test_paged_capacity_math():
    """tests/test_generation_paging.py's closed forms: the pool scales
    with num_pages, a page costs 2 x layers x heads x page x d_head x 4;
    and ``max_fitting_config`` picks the JAX engine's (slots, cap) at the
    same spec and budget (None with no budget, as there). The port's
    carry holds 12 more bytes a slot than the JAX one (a slot's random
    stream is two int64 words where the JAX key is two uint32, and an
    int32 more), so each budget sits 16 bytes a slot above the JAX size,
    clear of that difference."""
    je, pe = _engines(paged=True)
    assert pe.paged and pe.page_size == 8
    assert pe.max_pages_for(24) == 3 and pe.default_num_pages(2, 24) == 6
    full, small = pe.state_nbytes(2, 24), pe.state_nbytes(2, 24, 3)
    assert full - small == 2 * 2 * 3 * 2 * 8 * 8 * 4
    assert pe.page_nbytes() == 2 * 2 * 2 * 8 * 8 * 4
    with pytest.raises(ValueError, match="cannot seat"):
        pe.alloc_state(2, 24, num_pages=2)
    with pytest.raises(ValueError, match="max_positions"):
        pe.alloc_state(1, 65)
    assert pe.state_nbytes(2, 24) - je.state_nbytes(2, 24) == 2 * (
        pengine._CARRY_BYTES_PER_SLOT - (4 + 8 + 1 + 4 + 4 + 4)) == 2 * 12
    assert pe.max_fitting_config(2) is None
    assert je.max_fitting_config(2) is None
    for s, c in ((2, 24), (2, 16), (1, 24), (1, 16)):
        budget = je.state_nbytes(s, c) + 16 * s
        got = pe.max_fitting_config(2, budget)
        assert got == je.max_fitting_config(2, budget) == (s, c)
    assert pe.max_fitting_config(2, 8) is None
    assert je.max_fitting_config(2, 8) is None


def test_carries_are_reused_and_graph_bindings_checked(pair):
    """A freed state's tensors go to the next alloc_state of its key,
    zeroed; two live states never share one; a captured chunk's bindings
    read as rebound after ``set_var`` of a parameter."""
    _je, pe = pair
    a = pe.alloc_state(2, 24)
    pe.admit(a, 0, _prompts([6])[0], 8)
    first = [id(t) for t in a.pack()]
    b = pe.alloc_state(2, 24)
    assert not set(first) & {id(t) for t in b.pack()}
    pe.free_state(a)
    with pytest.raises(ValueError, match="freed"):
        pe.decode_chunk(a, 1)
    c = pe.alloc_state(2, 24)
    assert [id(t) for t in c.pack()] == first
    assert not c.logits.any() and bool(c.done.all())
    assert not any(t.any() for t in c.cache_k)
    step = pe._traced_step(24)
    g = pengine._Graph(None, None, c.pack(), pe._params(step))
    assert not g.rebound(c, pe.scope)
    name = step.param_names[0]
    pe.scope.set_var(name, pe.scope.find_var(name).clone())
    assert g.rebound(c, pe.scope)
    pe.free_state(b)
    pe.free_state(c)


def test_generate_from_threads_matches_serial(pair):
    """8 threads calling ``generate`` on one engine at once (a short
    switch interval, so the threads interleave inside the engine): each
    gets its serial result, and every carry they took went back to the
    pool."""
    import sys
    import threading
    _je, pe = pair
    jobs = [_prompts([3 + i, 16 - i], seed=20 + i) for i in range(8)]
    want = [[o.tolist() for o in pe.generate(j, 5)] for j in jobs]
    got = [None] * len(jobs)

    def run(i):
        got[i] = [o.tolist() for o in pe.generate(jobs[i], 5)]

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(jobs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert got == want
    free = sum(len(v) for v in pe._free_carries.values())
    assert free == pe.stats["carries"]


def test_default_place_is_the_card():
    with punique.guard():
        spec = ptransformer.build_lm(**TINY)["spec"]
    if torch.cuda.is_available():
        assert DecodeEngine(spec).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CPUPlace"):
            DecodeEngine(spec)


# ---------------------------------------------------------------------------
# the sampling stream
# ---------------------------------------------------------------------------

def _draw(logits, temps, topks, n, seed=0):
    """``n`` draws per row of ``logits`` from consecutive counters."""
    s = logits.shape[0]
    rngs = torch.from_numpy(np.stack([psampling.make_rng_row(seed + i)
                                      for i in range(s)]))
    got = []
    for _ in range(n):
        toks, rngs = psampling.sample_step(logits, rngs, temps, topks, 8)
        got.append(toks)
    return torch.stack(got).numpy()


@pytest.mark.parametrize("top_k", [0, 3])
def test_sampled_frequencies_follow_the_softmax(top_k):
    """3000 draws of each of 2 rows at temperature 0.7: every token's
    frequency within 5 binomial standard deviations of its probability
    (the softmax, renormalized over the top-k for top_k > 0)."""
    logits = torch.tensor([[1.0, 0.5, -0.2, 0.0, -1.0, 0.3],
                           [0.0, 0.05, 2.0, -0.5, 0.1, -0.2]])
    temp, n = 0.7, 3000
    draws = _draw(logits, torch.full((2,), temp), torch.full((2,), top_k),
                  n, seed=11)
    for r in range(2):
        z = logits[r].double() / temp
        if top_k:
            keep = torch.topk(z, top_k).indices
            z = torch.full_like(z, float("-inf")).index_copy(0, keep, z[keep])
        p = torch.softmax(z, 0).numpy()
        freq = np.bincount(draws[:, r], minlength=6) / n
        sd = np.sqrt(p * (1 - p) / n)
        assert np.all(np.abs(freq - p) <= 5 * sd + 1e-12), (freq, p)


def test_greedy_rows_and_the_greedy_only_head():
    logits = torch.randn(3, 10, generator=torch.Generator().manual_seed(0))
    rngs = torch.from_numpy(np.stack([psampling.make_rng_row(i)
                                      for i in range(3)]))
    temps = torch.tensor([0.0, 1.0, 0.0])
    toks, nxt = psampling.sample_step(logits, rngs, temps,
                                      torch.zeros(3, dtype=torch.int32), 4)
    assert toks.dtype == torch.int32
    assert toks[[0, 2]].tolist() == logits.argmax(-1)[[0, 2]].tolist()
    # every row's counter advances once, greedy rows too; keys stay
    assert torch.equal(nxt[:, 0], rngs[:, 0])
    assert torch.equal(nxt[:, 1], rngs[:, 1] + 1)
    toks0, same = psampling.sample_step(logits, rngs, temps,
                                        torch.zeros(3, dtype=torch.int32), 0)
    assert same is rngs
    assert toks0.tolist() == logits.argmax(-1).tolist()


def test_rng_rows_are_private_to_the_seed():
    rows = [psampling.make_rng_row(s) for s in (0, 1, 2**32, 2**40 + 5)]
    assert len({int(r[0]) for r in rows}) == 4
    assert all(r.dtype == np.int64 and 0 <= r[0] < 2**32 and r[1] == 0
               for r in rows)
    assert np.array_equal(psampling.make_rng_row(7),
                          psampling.make_rng_row(7))
    vh = psampling.vocab_hash(50, "cpu")
    u = psampling.uniforms(torch.from_numpy(np.stack(rows)), vh)
    assert u.shape == (4, 50) and bool(((u > 0) & (u < 1)).all())
    # a row's uniforms do not depend on the other rows
    assert torch.equal(u[2], psampling.uniforms(
        torch.from_numpy(rows[2][None]), vh)[0])
