"""The port's paged KV cache, on the CPU at ``tinyllama-1.1b --reduced``:
the reference suite's allocator and pool property tests, prefix hashing,
paged-vs-dense token identity across backend × wbits, the engine's
release, growth and budget split, and the scheduler's cross-feature runs
(``tests/test_paged_kv.py``, ported; its 2×2-mesh case waits for sharded
serving) — then the port against the JAX package on the same prompts and
carried-over weights: prefix hashes byte for byte (tokens-only and bf16
VLM frontends), ``admit_slot``/``decode_slots`` tokens exactly, and the
gathered paged cache within ``BF16_TOL``.

Tolerances: tokens, page tables and hashes are compared exactly. KV
entries are bf16 projections that both packages round at the same places
but reduce in different orders: atol = rtol = 4e-2, a few bf16 ulps (as in
``tests/test_torch_model.py``).

Identity scoping, as in the reference: paged-vs-dense identity is held on
fully occupied slots; under slot recycling, free slots' garbage (their own
dense rows against the shared garbage page) feeds the batched selection
and may differ between the layouts, so the recycled runs hold the pool's
steady state and replay determinism instead.

The port runs single-threaded here (a module fixture, restored after): the
CPU's intra-op threads cost ten times the arithmetic at these widths.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import build_model as jbuild
from repro.serving import ServeEngine as JEngine
from repro.serving.kv_pool import prompt_prefix_hashes as j_hashes
from repro_torch.configs import get_config as tget
from repro_torch.core.paged_kv import GARBAGE_PAGE, KVPoolExhausted, PagedKVAllocator
from repro_torch.models import build_model as tbuild
from repro_torch.models import params_from_reference
from repro_torch.models.attention import gather_paged_kv
from repro_torch.serving import (
    IO_SUMMARY_KEYS,
    KVPagePool,
    Request,
    Scheduler,
    ServeEngine,
    prompt_prefix_hashes,
)
from torch_threads import one_thread  # noqa: F401

BF16_TOL = dict(atol=4e-2, rtol=4e-2)


@pytest.fixture(scope="module")
def lm():
    jcfg = jget("tinyllama-1.1b").reduced()
    cfg = tget("tinyllama-1.1b").reduced()
    jm, model = jbuild(jcfg), tbuild(cfg)
    jp = jm.init(jax.random.key(0))
    params = params_from_reference(jax.device_get(jp), cfg, "cpu")
    return cfg, model, params, jm, jp


def _paged_engine(model, params, batch=2, pt=8, pages=None, **kw):
    kw.setdefault("cache_mb", 64.0)
    return ServeEngine(model, params, max_seq=32, batch_size=batch, device="nano",
                       sparsity=0.4, method="chunk", seed=5, kv_page_tokens=pt,
                       kv_pages=pages, torch_device="cpu", **kw)


def _dense_engine(model, params, batch=2, **kw):
    kw.setdefault("cache_mb", 64.0)
    return ServeEngine(model, params, max_seq=32, batch_size=batch, device="nano",
                       sparsity=0.4, method="chunk", seed=5, torch_device="cpu", **kw)


def _prompt(cfg, seed, n=12):
    rng = np.random.default_rng(seed)
    return {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, n)))}


def _shared_prefix_prompts(cfg, n, prefix_len=16, tail=4, seed=0):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, cfg.vocab_size, (1, prefix_len))
    return [{"tokens": torch.from_numpy(np.concatenate(
        [prefix, rng.integers(0, cfg.vocab_size, (1, tail))], axis=1))} for _ in range(n)]


def _first_tokens(lasts):
    return torch.cat([torch.argmax(last, dim=-1)[:, None] for last in lasts])


# -- allocator: construction and basic lifecycle ------------------------------


def test_allocator_validation():
    with pytest.raises(ValueError):
        PagedKVAllocator(1, 8)
    with pytest.raises(ValueError):
        PagedKVAllocator(8, 0)


def test_allocator_double_free_and_garbage_page_guards():
    a = PagedKVAllocator(4, 8)
    p = a.alloc()
    a.release(p)
    with pytest.raises(ValueError, match="double free"):
        a.release(p)
    with pytest.raises(ValueError):
        a.release(GARBAGE_PAGE)
    with pytest.raises(ValueError):
        a.retain(GARBAGE_PAGE)
    with pytest.raises(ValueError):
        a.retain(p)  # ref 0: not live
    a.check()


def test_allocator_exhaustion_raises_then_recovers():
    a = PagedKVAllocator(3, 8)  # capacity 2
    p0, p1 = a.alloc(), a.alloc()
    with pytest.raises(KVPoolExhausted):
        a.alloc()
    a.release(p0)
    assert a.alloc() == p0  # LIFO reuse
    a.check()
    assert a.n_live == 2 and a.n_free == 0
    del p1


# -- allocator: COW fork isolation --------------------------------------------


def test_cow_fork_isolation():
    a = PagedKVAllocator(8, 8)
    row = [a.alloc(), a.alloc()]
    forked = a.fork(row)
    assert forked == row  # same physical pages, shared
    assert all(a.refcount(p) == 2 for p in row)
    # a write to the fork must first materialize a private copy
    w, src = a.prepare_write(forked[0])
    assert src == row[0] and w != row[0]
    assert a.refcount(row[0]) == 1  # original owner keeps its page
    assert a.refcount(w) == 1
    assert a.cow_copies == 1
    # row[1] is still shared (ref 2): its write must copy too
    w2, src2 = a.prepare_write(row[1])
    assert src2 == row[1] and w2 != row[1]
    assert a.cow_copies == 2
    # a now-private anonymous page writes in place, no copy
    w3, src3 = a.prepare_write(w2)
    assert (w3, src3) == (w2, None)
    a.check()


def test_prepare_write_copies_registered_page_even_at_ref_one():
    """Registered prefix content must stay immutable: a future admission
    may revive it by hash, so even a sole owner writes a private copy."""
    a = PagedKVAllocator(8, 8)
    p = a.alloc()
    a.register_prefix(p, "h0")
    w, src = a.prepare_write(p)
    assert src == p and w != p
    a.check()


# -- allocator: eviction ------------------------------------------------------


def test_eviction_never_reclaims_live_pages():
    a = PagedKVAllocator(6, 8)  # capacity 5
    live = [a.alloc() for _ in range(3)]
    cold = []
    for i in range(2):
        p = a.alloc()
        a.register_prefix(p, f"h{i}")
        a.release(p)  # -> cold, evictable
        cold.append(p)
    assert a.n_live == 3 and a.n_cold == 2 and a.n_free == 0
    # an allocation burst may only ever reclaim the cold pages
    extra = [a.alloc(), a.alloc()]
    assert set(extra) == set(cold)
    assert all(a.refcount(p) == 1 for p in live)
    with pytest.raises(KVPoolExhausted):
        a.alloc()
    assert a.evictions == 2
    a.check()


def test_cold_lru_eviction_and_revival():
    a = PagedKVAllocator(8, 8)
    pages = []
    for i in range(3):
        p = a.alloc()
        a.register_prefix(p, f"h{i}")
        pages.append(p)
    for p in pages:  # cold in order h0, h1, h2
        a.release(p)
    assert a.evict_cold(1) == 1  # LRU: h0 goes first
    assert a.lookup_prefix("h0") is None
    revived = a.lookup_prefix("h1")
    assert revived == pages[1] and a.refcount(revived) == 1
    assert a.shared_hits == 1
    a.check()


# -- allocator: randomized property suite -------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_allocator_randomized_invariants(seed):
    """400 random alloc/retain/release/fork/register/lookup/evict/COW ops
    with ``check()`` (conservation, no dup free-list entries, refcount
    sanity) after every single operation. A shadow model tracks how many
    references we hold per page; terminal state must release cleanly."""
    rng = np.random.default_rng(seed)
    a = PagedKVAllocator(int(rng.integers(4, 20)), 8)
    held: list = []   # one entry per reference we own
    nkeys = 0
    for _ in range(400):
        op = rng.integers(0, 7)
        if op == 0:  # alloc
            try:
                held.append(a.alloc())
            except KVPoolExhausted:
                assert a.n_reclaimable == 0
        elif op == 1 and held:  # release one of our references
            a.release(held.pop(int(rng.integers(len(held)))))
        elif op == 2 and held:  # retain (fork a single page)
            p = held[int(rng.integers(len(held)))]
            held.append(a.retain(p))
        elif op == 3 and held:  # register a prefix hash
            p = held[int(rng.integers(len(held)))]
            a.register_prefix(p, f"k{nkeys}")
            nkeys += 1
        elif op == 4 and nkeys:  # lookup (live retain or cold revival)
            p = a.lookup_prefix(f"k{int(rng.integers(nkeys))}")
            if p is not None:
                held.append(p)
        elif op == 5:  # evict some cold pages
            a.evict_cold(int(rng.integers(1, 3)))
        elif op == 6 and held:  # COW write barrier
            i = int(rng.integers(len(held)))
            try:
                w, src = a.prepare_write(held[i])
            except KVPoolExhausted:  # copy needs a page the pool lacks
                assert a.n_reclaimable == 0
            else:
                if src is not None:
                    held[i] = w  # our ref moved to the fresh private copy
        a.check()
        # every reference we hold is on a live page
        for p in held:
            assert a.refcount(p) > 0
    for p in held:  # full teardown must conserve pages
        a.release(p)
        a.check()
    assert a.n_live == 0
    assert a.n_cold + a.n_free == a.capacity


# -- prefix hashing -----------------------------------------------------------


def test_prefix_hashes_batch_dim_validation():
    with pytest.raises(ValueError):
        prompt_prefix_hashes({"tokens": torch.zeros((2, 8), dtype=torch.int64)}, 4)


def test_prefix_hashes_chain_and_length_folding():
    t = np.arange(16).reshape(1, 16)
    n, h = prompt_prefix_hashes({"tokens": torch.from_numpy(t)}, 4)
    assert n == 16 and len(h) == 4
    # changing a token in the LAST page only perturbs the last hash
    t2 = t.copy()
    t2[0, 14] += 1
    _, h2 = prompt_prefix_hashes({"tokens": torch.from_numpy(t2)}, 4)
    assert h2[:3] == h[:3] and h2[3] != h[3]
    # changing a token in the FIRST page perturbs every chained hash
    t3 = t.copy()
    t3[0, 0] += 1
    _, h3 = prompt_prefix_hashes({"tokens": torch.from_numpy(t3)}, 4)
    assert all(x != y for x, y in zip(h3, h))
    # the same 8-token prefix under another TOTAL length must not collide
    _, h4 = prompt_prefix_hashes({"tokens": torch.from_numpy(t[:, :8])}, 4)
    assert h4[0] != h[0]
    # the partial tail page gets no hash
    n5, h5 = prompt_prefix_hashes({"tokens": torch.from_numpy(t[:, :14])}, 4)
    assert n5 == 14 and len(h5) == 3


def test_prefix_hashes_cover_frontend_and_extra_keys():
    t = torch.arange(8).reshape(1, 8)
    fr = torch.ones((1, 2, 4), dtype=torch.float32)
    n, h = prompt_prefix_hashes({"tokens": t, "frontend": fr}, 4)
    assert n == 10  # 2 frontend rows fuse ahead of the tokens
    _, h2 = prompt_prefix_hashes({"tokens": t, "frontend": fr + 1}, 4)
    assert h != h2
    _, h3 = prompt_prefix_hashes({"tokens": t, "frontend": fr, "aux": torch.ones(2)}, 4)
    assert h != h3


@pytest.mark.parametrize("page_tokens", [4, 8])
def test_prefix_hashes_equal_reference_tokens(page_tokens):
    """Tokens hash as 8-byte integers whatever their dtype: the port's
    int64 tensors and the reference's int32 arrays give the same chain."""
    t = np.random.default_rng(3).integers(0, 32000, (1, 21))
    want = j_hashes({"tokens": jnp.asarray(t, jnp.int32)}, page_tokens)
    assert prompt_prefix_hashes({"tokens": torch.from_numpy(t)}, page_tokens) == want
    assert prompt_prefix_hashes({"tokens": t}, page_tokens) == want


@pytest.mark.parametrize("front_dtype", ["bfloat16", "float32"])
def test_prefix_hashes_equal_reference_vlm(front_dtype):
    """A VLM prompt's frontend rows hash as their raw bytes: a bf16 tensor's
    2-byte patterns (through ``view(torch.int16)``) equal the reference's
    ml_dtypes bfloat16 array's, and an extra batch leaf folds in alike."""
    rng = np.random.default_rng(4)
    t = rng.integers(0, 512, (1, 9))
    fr = rng.normal(0, 1, (1, 7, 16)).astype(np.float32)
    aux = rng.normal(0, 1, (3,)).astype(np.float32)
    jfr = jnp.asarray(fr, getattr(jnp, front_dtype))
    tfr = torch.from_numpy(fr).to(getattr(torch, front_dtype))
    want = j_hashes({"tokens": jnp.asarray(t, jnp.int32), "frontend": jfr,
                     "aux": jnp.asarray(aux)}, 4)
    got = prompt_prefix_hashes({"tokens": torch.from_numpy(t), "frontend": tfr,
                                "aux": torch.from_numpy(aux)}, 4)
    assert got == want and got[0] == 16 and len(got[1]) == 4


# -- KVPagePool ---------------------------------------------------------------


def test_pool_validation():
    with pytest.raises(ValueError):
        KVPagePool(2, max_seq=30, page_tokens=8, n_pages=8, page_bytes=1.0)
    with pytest.raises(ValueError):
        KVPagePool(3, max_seq=32, page_tokens=8, n_pages=8, page_bytes=1.0,
                   n_data_shards=2)


def test_pool_share_release_revive_cycle():
    pool = KVPagePool(2, max_seq=32, page_tokens=8, n_pages=16, page_bytes=1.0)
    seq, hashes = 20, ["a", "b"]  # 2 full pages + partial tail
    e0 = pool.admit(0, seq, hashes)
    assert [f for _, f in e0] == [True, True, True]
    e1 = pool.admit(1, seq, hashes)  # full pages shared, tail private
    assert [f for _, f in e1] == [False, False, True]
    assert e1[0][0] == e0[0][0] and e1[2][0] != e0[2][0]
    assert pool.shared_pages == 2 and pool.pages_in_use == 4
    assert pool.shared_pages_hit == 2
    pool.check()
    pool.release(0)
    assert pool.pages_in_use == 3 and pool.shared_pages == 0
    pool.release(1)
    # registered pages go cold, not free: a re-admission revives them
    assert pool.steady_state() and pool.alloc.n_cold == 2
    e2 = pool.admit(0, seq, hashes)
    assert [f for _, f in e2] == [False, False, True]
    pool.check()


def test_pool_exhaustion_rolls_back_partial_admission():
    pool = KVPagePool(1, max_seq=32, page_tokens=8, n_pages=3, page_bytes=1.0)
    assert not pool.can_admit(24, ["a", "b", "c"])
    with pytest.raises(KVPoolExhausted):
        pool.admit(0, 24, ["a", "b", "c"])  # needs 3 pages, capacity 2
    # the partial admission fully rolled back
    assert pool.pages_in_use == 0 and pool.steady_state()
    pool.check()
    assert pool.can_admit(16, ["a", "b"])
    pool.admit(0, 16, ["a", "b"])
    pool.check()


def test_pool_max_seq_prompt_keeps_final_page_private():
    """Review regression: a prompt of exactly max_seq tokens fills its
    final page, but decode clamps writes to max_seq-1 — inside it. The
    final page must stay private and unregistered or the clamped decode
    write would mutate shared bytes and poison the prefix registry."""
    pool = KVPagePool(2, max_seq=32, page_tokens=8, n_pages=16, page_bytes=1.0)
    hashes = ["a", "b", "c", "d"]  # 4 full pages: seq_len == max_seq
    e0 = pool.admit(0, 32, hashes)
    assert [f for _, f in e0] == [True] * 4
    last0 = e0[-1][0]
    assert last0 not in pool.alloc._hash_of  # clamp target: unregistered
    assert pool.can_admit(32, hashes)
    e1 = pool.admit(1, 32, hashes)
    # first three pages share; each slot gets its own private final page
    assert [f for _, f in e1] == [False, False, False, True]
    assert e1[-1][0] != last0
    assert pool.shared_pages == 3
    pool.check()
    pool.release(0)
    pool.release(1)
    # only the shareable pages cold-retire; the private finals went free
    assert pool.alloc.n_cold == 3 and pool.steady_state()
    pool.check()


def test_pool_exhaustion_rollback_never_cold_retires_unwritten_pages():
    """Review regression: a mid-admit rollback must forget the hashes of
    fresh pages registered during the failed admission — their KV bytes
    were never written (the engine writes prefill bytes only after admit
    returns), so letting them cold-retire would let a later same-prefix
    admission revive zero-filled KV as real prompt content."""
    pool = KVPagePool(1, max_seq=32, page_tokens=8, n_pages=3, page_bytes=1.0)
    with pytest.raises(KVPoolExhausted):
        pool.admit(0, 24, ["a", "b", "c"])  # registers "a","b", then fails
    assert pool.alloc.n_cold == 0  # nothing revivable survived the rollback
    assert pool.alloc._by_hash == {} and pool.alloc._hash_of == {}
    assert pool.fresh_pages == 0  # counter rolled back with the pages
    pool.check()
    # a retry of the same prefix must allocate FRESH pages, never "share"
    entries = pool.admit(0, 16, ["a", "b"])
    assert [f for _, f in entries] == [True, True]
    assert pool.shared_pages_hit == 0
    pool.check()


def test_pool_page_home_follows_recycled_cold_eviction():
    """Review regression: a page recycled after cold eviction must take
    its NEW owner's data shard as home — setdefault kept the stale one,
    drifting the per-shard split pages_per_shard reports."""
    pool = KVPagePool(4, max_seq=32, page_tokens=8, n_pages=4, page_bytes=1.0,
                      n_data_shards=2)  # slots 0-1 -> shard 0, 2-3 -> shard 1
    pool.admit(0, 8, ["a"])
    assert pool.pages_per_shard() == [1, 0]
    pool.release(0)  # registered page goes cold, home retained
    # a shard-1 admission needs all 3 pages: the cold page is evicted and
    # recycled, and its home must follow the new owner
    pool.admit(2, 24, [])
    assert pool.pages_per_shard() == [0, 3]
    assert sum(pool.pages_per_shard()) == pool.pages_in_use
    pool.check()


def test_pool_ensure_grows_private_pages_and_clamps():
    pool = KVPagePool(1, max_seq=32, page_tokens=8, n_pages=8, page_bytes=1.0)
    pool.admit(0, 12, ["a"])  # 2 pages
    # pages_needed is the pure twin of ensure: counts, allocates nothing
    assert pool.pages_needed(0, 15) == 0
    assert pool.pages_needed(0, 17) == 1
    assert pool.pages_needed(0, 100) == 2    # clamped to max_seq-1
    assert len(pool.slot_pages(0)) == 2      # nothing allocated by counting
    assert pool.ensure(0, 15) == []          # still inside page 1
    assert len(pool.ensure(0, 17)) == 1      # page 2
    assert len(pool.ensure(0, 100)) == 1     # clamped to max_seq-1 -> page 3
    assert len(pool.slot_pages(0)) == 4
    pool.check()


def test_pool_pages_per_shard_sums_to_global():
    pool = KVPagePool(4, max_seq=32, page_tokens=8, n_pages=32, page_bytes=1.0,
                      n_data_shards=2)
    for slot, seed in enumerate([0, 0, 1, 2]):  # slots 0,1 share a prompt
        seq, hashes = 16, [f"s{seed}p0", f"s{seed}p1"]
        pool.admit(slot, seq, hashes)
    per = pool.pages_per_shard()
    assert sum(per) == pool.pages_in_use
    assert len(per) == 2 and all(p > 0 for p in per)
    pool.check()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pool_randomized_invariants(seed):
    """Random admit/ensure/release storms over few pages: ``check()``
    (table mirror <-> refcount cross-invariant) after every op, exhaustion
    always rolls back cleanly, and teardown reaches steady state."""
    rng = np.random.default_rng(seed)
    pool = KVPagePool(4, max_seq=64, page_tokens=8,
                      n_pages=int(rng.integers(6, 24)), page_bytes=1.0)
    prompts = []
    for i in range(5):  # few distinct prompts -> plenty of sharing
        seq = int(rng.integers(4, 40))
        n_full = seq // 8
        prompts.append((seq, [f"p{i}.{j}" for j in range(n_full)]))
    for _ in range(300):
        op = rng.integers(0, 3)
        slot = int(rng.integers(4))
        if op == 0:
            seq, hashes = prompts[int(rng.integers(len(prompts)))]
            before = pool.pages_in_use
            fits = pool.can_admit(seq, hashes)
            had = len(pool.slot_pages(slot))
            try:
                pool.admit(slot, seq, hashes)
            except KVPoolExhausted:
                # can_admit may pass yet admit fail only if the slot's own
                # prior pages were recycled into the estimate; state must
                # still be exactly "slot released, nothing allocated"
                assert pool.slot_pages(slot) == []
                assert pool.pages_in_use <= before
                if had == 0:
                    assert not fits
        elif op == 1 and pool.slot_pages(slot):
            try:
                pool.ensure(slot, int(rng.integers(64)))
            except KVPoolExhausted:
                # partial growth is kept (already mapped into the table);
                # check() below proves the state stayed consistent
                assert pool.alloc.n_reclaimable == 0
        elif op == 2:
            pool.release(slot)
        pool.check()
        assert sum(pool.pages_per_shard()) == pool.pages_in_use
    for slot in range(4):
        pool.release(slot)
        pool.check()
    assert pool.steady_state()


# -- engine integration: validation and budget split --------------------------


def test_engine_paged_validation(lm):
    cfg, model, params, *_ = lm
    with pytest.raises(ValueError, match="kv_pages requires"):
        _dense_engine(model, params, kv_pages=8)
    with pytest.raises(ValueError, match="kv_page_tokens"):
        _paged_engine(model, params, pt=7)  # 32 % 7 != 0
    eng = _paged_engine(model, params)
    with pytest.raises(NotImplementedError):
        eng.prefill(_prompt(cfg, 0))
    with pytest.raises(NotImplementedError):
        eng.append_frame(torch.zeros((1, 1, cfg.d_model)))


def test_engine_budget_split_and_io_summary(lm):
    cfg, model, params, *_ = lm
    for k in ("kv_cache_mb", "weight_cache_mb", "kv_pages_in_use", "kv_shared_pages"):
        assert k in IO_SUMMARY_KEYS
    dense = _dense_engine(model, params)
    sd = dense.io_summary()
    assert sd["kv_cache_mb"] == 0.0
    assert sd["weight_cache_mb"] == pytest.approx(dense.cache_mb)
    paged = _paged_engine(model, params)
    sp = paged.io_summary()
    assert sp["kv_cache_mb"] > 0.0
    assert sp["weight_cache_mb"] == pytest.approx(paged.cache_mb - sp["kv_cache_mb"])
    # the weight tier budget the sparse executor sees is the carved split
    assert paged.sparse_ctx.cache_mb == pytest.approx(sp["weight_cache_mb"])
    assert sp["kv_pages_in_use"] == 0 and sp["kv_shared_pages"] == 0


# -- engine integration: paged vs dense byte identity -------------------------


def _identity_run(model, params, cfg, batch=2, new_tokens=6, shared=False, **kw):
    """Admit every slot (full occupancy — see module docstring), decode,
    and return (dense_tokens, paged_tokens, paged_engine)."""
    dense = _dense_engine(model, params, batch=batch, **kw)
    paged = _paged_engine(model, params, batch=batch, **kw)
    if shared:
        prompts = _shared_prefix_prompts(cfg, batch, prefix_len=16, tail=4)
    else:
        prompts = [_prompt(cfg, 100 + i) for i in range(batch)]
    outs = []
    for eng in (dense, paged):
        eng.enable_slots()
        lasts = [eng.admit_slot(slot, p)[0] for slot, p in enumerate(prompts)]
        out, _ = eng.decode_slots(_first_tokens(lasts), new_tokens)
        outs.append(out.numpy())
    return outs[0], outs[1], paged


def test_paged_vs_dense_identity(lm):
    cfg, model, params, *_ = lm
    d, p, eng = _identity_run(model, params, cfg)
    np.testing.assert_array_equal(d, p)
    pool = eng.kv_pool
    assert pool.pages_in_use > 0
    pool.check()
    # decode growth allocated only private anonymous pages
    assert pool.shared_pages == 0


def test_paged_shared_prefix_identity_and_page_savings(lm):
    cfg, model, params, *_ = lm
    d, p, eng = _identity_run(model, params, cfg, shared=True)
    np.testing.assert_array_equal(d, p)
    pool = eng.kv_pool
    assert pool.shared_pages_hit >= 2  # 16-token prefix = 2 shared pages
    # sharing saved real pages vs. the unshared dense-equivalent footprint
    unshared = sum(len(pool.slot_pages(s)) for s in range(pool.n_slots))
    assert pool.pages_in_use < unshared
    pool.check()


@pytest.mark.parametrize("backend,wbits", [("reference", 8), ("kernel", 16), ("kernel", 8)])
def test_paged_vs_dense_identity_backend_wbits(lm, backend, wbits):
    cfg, model, params, *_ = lm
    d, p, eng = _identity_run(model, params, cfg, backend=backend, wbits=wbits)
    np.testing.assert_array_equal(d, p)
    eng.kv_pool.check()


def test_paged_vs_dense_identity_max_seq_prompts(lm):
    """Two slots admitted with the SAME max_seq-length prompt share every
    shareable page; decode's clamped write at max_seq-1 must land in each
    slot's private final page. The streams are forced to diverge
    (different first decode inputs), so a shared final page would
    cross-contaminate the slots and break dense identity."""
    cfg, model, params, *_ = lm
    dense = _dense_engine(model, params)
    paged = _paged_engine(model, params)
    p = _prompt(cfg, 7, n=32)  # exactly max_seq
    outs = []
    for eng in (dense, paged):
        eng.enable_slots()
        last0, _ = eng.admit_slot(0, p)
        eng.admit_slot(1, p)
        t0 = int(torch.argmax(last0, dim=-1)[0])
        toks = torch.tensor([[t0], [(t0 + 1) % cfg.vocab_size]])
        out, _ = eng.decode_slots(toks, 4)
        outs.append(out.numpy())
    np.testing.assert_array_equal(outs[0], outs[1])
    pool = paged.kv_pool
    finals = [pool.slot_pages(s)[-1] for s in range(2)]
    assert finals[0] != finals[1]  # private clamp targets, one per slot
    assert all(f not in pool.alloc._hash_of for f in finals)
    assert pool.shared_pages == 3  # the first three pages still share
    pool.check()


# -- engine integration: release and growth -----------------------------------


def test_engine_release_slot_returns_pages(lm):
    cfg, model, params, *_ = lm
    eng = _paged_engine(model, params)
    eng.enable_slots()
    last, _ = eng.admit_slot(0, _prompt(cfg, 0))
    tok = torch.cat([torch.argmax(last, dim=-1)[:, None], torch.zeros((1, 1), dtype=torch.int64)])
    eng.decode_slots(tok, 4)
    assert eng.kv_pool.pages_in_use > 0
    assert int(eng.slot_lengths()[0]) > 0
    # the host mirror the growth pre-check reads is the card's lengths
    np.testing.assert_array_equal(eng._host_lengths, eng.slot_lengths())
    eng.release_slot(0)
    assert int(eng.slot_lengths()[0]) == 0
    assert eng.kv_pool.steady_state()
    assert eng.io_summary()["kv_pages_in_use"] == 0
    eng.kv_pool.check()
    with pytest.raises(ValueError):
        eng.release_slot(9)


def test_engine_decode_growth_exhaustion_is_atomic(lm):
    """When a decode round's page growth cannot fit the pool, decode_slots
    raises BEFORE allocating anything or mutating any page table — so the
    caller can preempt a slot and retry."""
    cfg, model, params, *_ = lm
    eng = _paged_engine(model, params, pages=5)  # capacity 4
    eng.enable_slots()
    lasts = [eng.admit_slot(slot, _prompt(cfg, 100 + slot, n=12))[0] for slot in range(2)]
    pool = eng.kv_pool
    assert pool.pages_in_use == 4 and pool.reclaimable_pages == 0
    pages_before = [pool.slot_pages(s) for s in range(2)]
    table_before = pool.table.copy()
    device_table = eng.cache["page_table"].clone()
    toks = _first_tokens(lasts)
    with pytest.raises(KVPoolExhausted):
        eng.decode_slots(toks, 8)  # both slots need a third page
    # nothing was allocated, no table mutated: the failure is recoverable
    assert [pool.slot_pages(s) for s in range(2)] == pages_before
    np.testing.assert_array_equal(pool.table, table_before)
    assert torch.equal(eng.cache["page_table"], device_table)
    assert pool.pages_in_use == 4
    pool.check()
    eng.release_slot(1)  # mimic a preemption freeing pages…
    out, _ = eng.decode_slots(toks, 8)  # …and the retry succeeds
    assert tuple(out.shape) == (2, 8)
    pool.check()


# -- cross-feature regressions: scheduler, faults, preemption -----------------


def _paged_sched_run(model, params, cfg, **eng_kw):
    eng = _paged_engine(model, params, batch=2, **eng_kw)
    eng.simulator.noise = 0.0
    sched = Scheduler(eng, round_tokens=2)
    reqs = []
    for i in range(6):
        p = _prompt(cfg, seed=i % 3, n=12)  # repeats -> prefix sharing
        reqs.append(Request(rid=i, prompt=p, max_new_tokens=4, arrival_s=0.002 * i))
    for r in reqs[:4]:
        r.deadline_s = 0.03  # force preemption traffic
    sched.submit(reqs)
    stats = sched.run()
    return eng, sched, reqs, stats


def test_scheduler_paged_faults_preemption_no_page_leaks(lm):
    """Paged KV + fault preemption + corruption rungs: every release path
    (eviction, preemption) funnels through the pool, so a fault-heavy run
    drains to pool steady state with zero leaked refcounts and coherent
    io_summary counters."""
    cfg, model, params, *_ = lm
    eng, sched, reqs, stats = _paged_sched_run(
        model, params, cfg, fault_profile="thermal_throttle", fault_seed=0,
        corruption_profile="bit_rot", corruption_seed=7)
    assert stats.finished == 6
    assert all(len(r.tokens_out) == 4 for r in reqs)
    pool = eng.kv_pool
    assert pool.steady_state(), pool.summary()
    pool.check()
    assert pool.released >= pool.admitted - 2  # every occupant released
    s = eng.io_summary()
    assert s["kv_pages_in_use"] == 0 and s["kv_shared_pages"] == 0
    assert pool.shared_pages_hit > 0  # repeated prompts actually shared
    assert sum(pool.pages_per_shard()) == 0


def test_scheduler_paged_run_deterministic(lm):
    """The same submission replayed on a fresh paged engine yields the same
    tokens — recycled-slot garbage (the garbage page's last-row-wins
    scatter included) cannot leak nondeterminism in."""
    cfg, model, params, *_ = lm
    outs = []
    for _ in range(2):
        _, _, reqs, _ = _paged_sched_run(model, params, cfg)
        outs.append([list(r.tokens_out) for r in reqs])
    assert outs[0] == outs[1]


def test_scheduler_release_accounting_through_pool(lm):
    """Scheduler eviction and preemption route release through
    ``engine.release_slot`` (pool-aware), so a drained run leaves every
    page returned."""
    cfg, model, params, *_ = lm
    eng = _paged_engine(model, params, batch=2)
    eng.simulator.noise = 0.0
    sched = Scheduler(eng, round_tokens=2)
    reqs = [Request(rid=i, prompt=_prompt(cfg, i), max_new_tokens=3, arrival_s=0.001 * i)
            for i in range(3)]
    sched.submit(reqs)
    stats = sched.run()
    assert stats.finished == 3
    assert eng.kv_pool.steady_state()
    assert eng.kv_pool.released == eng.kv_pool.admitted
    eng.kv_pool.check()


def test_scheduler_preempts_on_kv_page_pressure(lm):
    """Decode-time page growth outrunning a small pool does not kill the
    run — the scheduler preempts the least-urgent co-runner (EDF mirror),
    retries the round, and the preemptee drains after readmission."""
    cfg, model, params, *_ = lm
    eng = _paged_engine(model, params, pages=5)  # capacity 4
    eng.simulator.noise = 0.0
    sched = Scheduler(eng, round_tokens=8)
    reqs = [Request(rid=i, prompt=_prompt(cfg, 100 + i, n=12), max_new_tokens=8,
                    arrival_s=0.0) for i in range(2)]
    sched.submit(reqs)
    stats = sched.run()
    assert stats.finished == 2
    assert stats.preempted >= 1  # page pressure, not deadlines, forced it
    assert all(len(r.tokens_out) == 8 for r in reqs)
    assert reqs[1].preemptions >= 1  # rid 1: latest (arrival, rid) victim
    assert eng.kv_pool.steady_state()
    eng.kv_pool.check()


def test_scheduler_lone_runner_page_exhaustion_fails_fast(lm):
    """With no co-runner to preempt, decode growth past the pool surfaces
    as a clear sizing error, not a traceback from half-grown state."""
    cfg, model, params, *_ = lm
    eng = _paged_engine(model, params, pages=3)  # capacity 2: prompt only
    eng.simulator.noise = 0.0
    sched = Scheduler(eng, round_tokens=8)
    sched.submit(Request(rid=0, prompt=_prompt(cfg, 0, n=12), max_new_tokens=8,
                         arrival_s=0.0))
    with pytest.raises(RuntimeError, match="no\\s+co-runner"):
        sched.run()
    eng.kv_pool.check()  # pool state stayed consistent through the failure


# -- the port against the JAX package -----------------------------------------


def _jax_engine(jm, jp, paged, **kw):
    return JEngine(jm, jp, max_seq=32, batch_size=2, device="nano", sparsity=0.4,
                   method="chunk", seed=5, cache_mb=64.0,
                   kv_page_tokens=8 if paged else None, **kw)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("wbits", [16, 8])
def test_slot_tokens_equal_reference(lm, paged, wbits):
    """``admit_slot`` of two prompts sharing a 16-token prefix, then two
    ``decode_slots`` rounds: every token equals the JAX engine's, the page
    tables are the same pages, and each slot's gathered paged (or dense)
    cache agrees within BF16_TOL over its valid positions."""
    cfg, model, params, jm, jp = lm
    prompts = _shared_prefix_prompts(cfg, 2, prefix_len=16, tail=4, seed=1)
    jeng = _jax_engine(jm, jp, paged, wbits=wbits)
    teng = (_paged_engine if paged else _dense_engine)(model, params, wbits=wbits)
    jeng.enable_slots()
    teng.enable_slots()
    jl = [jeng.admit_slot(s, {"tokens": jnp.asarray(p["tokens"].numpy(), jnp.int32)})[0]
          for s, p in enumerate(prompts)]
    tl = [teng.admit_slot(s, p)[0] for s, p in enumerate(prompts)]
    jtok = jnp.concatenate([jnp.argmax(x, -1)[:, None] for x in jl]).astype(jnp.int32)
    ttok = _first_tokens(tl)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    for n in (3, 2):
        jout, jlat = jeng.decode_slots(jtok, n)
        tout, tlat = teng.decode_slots(ttok, n)
        np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
        np.testing.assert_allclose(tlat, np.asarray(jlat), rtol=1e-6)
        jtok, ttok = jout[:, -1:], tout[:, -1:]
    np.testing.assert_array_equal(teng.slot_lengths(), np.asarray(jeng.slot_lengths()))
    length = int(teng.slot_lengths()[0])
    for key in ("k", "v"):
        if paged:
            np.testing.assert_array_equal(teng.cache["page_table"].numpy(),
                                          np.asarray(jeng.cache["page_table"]))
            got = torch.stack([gather_paged_kv(teng.cache[key][layer], teng.cache["page_table"])
                               for layer in range(cfg.n_layers)])
            want = np.stack([np.asarray(jnp.take(jeng.cache[key][layer],
                                                 jeng.cache["page_table"], axis=0)
                                        .reshape(2, 32, *jeng.cache[key].shape[3:]))
                             for layer in range(cfg.n_layers)])
        else:
            got, want = teng.cache[key], np.asarray(jeng.cache[key])
        np.testing.assert_allclose(got[:, :, :length].float().numpy(),
                                   np.asarray(want[:, :, :length], np.float32), **BF16_TOL)
    if paged:
        assert teng.kv_pool.summary() == jeng.kv_pool.summary()
