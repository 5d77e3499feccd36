"""The port's host KV tier (``paddle_tpu_torch.serving.host_tier``)
against the JAX package's, on the CPU.

- The pool: ``prefix_digests`` chains, stored blobs and their CRCs equal
  the JAX package's for the same page values (f32 and bf16, which the port
  keeps as raw bytes named ``"bfloat16"``), put/get round trips with
  dedup, the LRU byte bound with backpressure, and quarantine of a
  bit-flipped page.
- The engine, on the tiny LM of ``tests/torch_fleet_lm.py`` and its five
  prompts sharing a 14-token system prefix: engine A writes its prefill
  pages through to a shared ``HostPagePool`` and is killed (its radix tree
  gone); engine B over the same pool promotes the pages back; with every
  promote read corrupted, engine C quarantines the pages and re-prefills;
  engine D's private pool gives back the deep pages its four-page tree
  evicted. In both packages, with tokens and tier counts equal to each
  other's and tokens to the JAX engine's references.

Every engine closes (or is killed) in ``finally`` and every wait has a
time limit.
"""

import time

import numpy as np
import pytest
import torch

import torch_fleet_lm as flm
from paddle_tpu.resilience import faults as jfaults
from paddle_tpu.serving import host_tier as jhost
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.serving import DecodeFleet, HostPageCorrupt, HostPagePool, prefix_digests
from paddle_tpu_torch.serving.host_tier import page_blob, page_from_blob

PS = flm.DC_PREFIX["page_size"]


@pytest.fixture(autouse=True)
def _no_leftover_faults():
    yield
    faults.clear()
    jfaults.clear()


@pytest.fixture(scope="module")
def lm():
    return flm.tiny_lm()


def _page(seed, dtype=torch.float32):
    return torch.randn(2, 4, PS, 8, generator=torch.Generator().manual_seed(seed)).to(dtype)


# ---- the pool ---------------------------------------------------------------------


def test_prefix_digests_equal_jax():
    toks = np.random.RandomState(3).randint(1, 97, size=(23,)).astype(np.int32)
    for ps in (1, 4, 8):
        assert prefix_digests(toks, ps) == jhost.prefix_digests(toks, ps)
    assert len(prefix_digests(toks, 4)) == 5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stored_blobs_equal_jax(dtype):
    """The same page values give the same stored bytes, CRCs, shape and
    dtype name in both pools, and the port's page comes back bit-equal."""
    import jax.numpy as jnp

    k, v = _page(1, getattr(torch, dtype)), _page(2, getattr(torch, dtype))
    jk, jv = (np.asarray(jnp.asarray(t.float().numpy(), getattr(jnp, dtype))) for t in (k, v))
    toks = np.arange(1, 2 * PS + 1, dtype=np.int32)
    mine, theirs = HostPagePool(1 << 20, PS), jhost.HostPagePool(1 << 20, PS)
    mine.put(toks, 1, k, v)
    theirs.put(toks, 1, jk, jv)
    a, b = next(iter(mine._entries.values())), next(iter(theirs._entries.values()))
    for slot in ("key", "k_blob", "v_blob", "k_crc", "v_crc", "shape", "dtype", "nbytes"):
        assert getattr(a, slot) == getattr(b, slot), slot
    gk, gv = mine.get(toks, 1)
    assert gk.dtype == k.dtype and torch.equal(gk, k) and torch.equal(gv, v)
    assert page_blob(k) == (jk.tobytes(), tuple(jk.shape), str(jk.dtype))
    assert torch.equal(page_from_blob(*page_blob(k)), k)


def test_pool_put_get_roundtrip_and_dedup():
    pool = HostPagePool(1 << 20, PS)
    toks = np.arange(1, 3 * PS + 1, dtype=np.int32)
    assert pool.get(toks, 0) is None and pool.stats()["misses"] == 1
    assert pool.put(toks, 0, _page(0), _page(1)) == {"added": 1, "evicted": 0}
    assert pool.put(toks, 0, _page(0), _page(1))["added"] == 0  # dedup
    assert pool.contains(toks, 1) and not pool.contains(toks, 2)
    k, v = pool.get(toks, 0)
    assert torch.equal(k, _page(0)) and torch.equal(v, _page(1))
    with pytest.raises(Exception):
        pool.put(toks[:PS - 1], 0, _page(0), _page(1))  # too few tokens for the page


def test_pool_lru_byte_bound_backpressure():
    one = 2 * _page(0).numel() * 4
    pool = HostPagePool(2 * one, PS)
    toks = np.arange(1, 4 * PS + 1, dtype=np.int32)
    for i in range(3):
        pool.put(toks, i, _page(i), _page(i + 10))
    st = pool.stats()
    assert (st["pages"], st["evicted"], st["backpressure"]) == (2, 1, 1)
    assert not pool.contains(toks, 1) and pool.contains(toks, 3)


def test_pool_crc_quarantine_on_bit_flip():
    pool = HostPagePool(1 << 20, PS)
    toks = np.arange(1, PS + 1, dtype=np.int32)
    pool.put(toks, 0, _page(0), _page(1))
    entry = next(iter(pool._entries.values()))
    entry.k_blob = bytes([entry.k_blob[0] ^ 0x01]) + entry.k_blob[1:]
    with pytest.raises(HostPageCorrupt):
        pool.get(toks, 0)
    assert pool.num_pages == 0 and pool.stats()["quarantined"] == 1


def test_pool_injected_faults():
    pool = HostPagePool(1 << 20, PS)
    toks = np.arange(1, 2 * PS + 1, dtype=np.int32)
    pool.put(toks, 0, _page(0), _page(1))
    with faults.injected(faults.FaultSpec(faults.HOST_TIER, "nan", match={"op": "promote"})):
        with pytest.raises(HostPageCorrupt):
            pool.get(toks, 0)
    with faults.injected(faults.FaultSpec(faults.HOST_TIER, "error", match={"op": "demote"})):
        with pytest.raises(OSError):
            pool.put(toks, 1, _page(2), _page(3))
    assert not pool.contains(toks, 2)


# ---- the engine -------------------------------------------------------------------


def _serve(eng, cases):
    return flm.tokens([eng.submit(p, n) for p, n, _ in cases])


def _tier_flows(lm, make, f, cls):
    """A serves and is killed; B (cold tree, same pool) promotes; C (cold
    tree, same pool) has every promote read corrupted; D, with a private
    pool and a four-page tree, serves the prompts and then each again
    after the tree evicted its deep page. Returns each one's tokens and
    metrics snapshot."""
    pool = cls(max_bytes=1 << 20, page_size=PS)
    out = {}
    for name in ("a", "b", "c"):
        eng = make(lm, label=f"tier-{name}", pool=pool, base=flm.DC_PREFIX)
        try:
            if name == "c":
                with f.injected(f.FaultSpec(f.HOST_TIER, "nan", times=10 ** 9,
                                            match={"op": "promote"})):
                    out[name] = _serve(eng, lm.prefixed)
            else:
                out[name] = _serve(eng, lm.prefixed)
            out[name + "_snap"] = eng.metrics.snapshot()
        finally:
            if name == "a":
                eng.kill()  # the tree dies with the engine, the pool does not
            else:
                eng.close(timeout=flm.WAIT_S)
        eng.kv.assert_no_leaks()
    out["pages"] = pool.num_pages
    eng = make(lm, label="tier-d", base=flm.DC_PREFIX, host_tier_bytes=1 << 20,
               prefix_cache_pages=4)
    try:
        out["d"] = _serve(eng, lm.prefixed)
        out["d_again"] = [flm.tokens([eng.submit(p, n)])[0] for p, n, _ in lm.prefixed]
        out["d_snap"] = eng.metrics.snapshot()
        out["d_private"] = eng.host_tier is not None and eng.host_tier is not pool
    finally:
        eng.close(timeout=flm.WAIT_S)
    eng.kv.assert_no_leaks()
    return out


@pytest.fixture(scope="module")
def jax_flows(lm):
    return _tier_flows(lm, flm.jax_engine, jfaults, jhost.HostPagePool)


@pytest.fixture(scope="module")
def port_flows(lm):
    return _tier_flows(lm, flm.port_engine, faults, HostPagePool)


def test_write_through_demote_equal_jax(lm, jax_flows, port_flows):
    want = flm.refs(lm.prefixed)
    assert port_flows["a"] == jax_flows["a"] == want
    snap = port_flows["a_snap"]
    assert snap["host_demoted_pages_total"] == jax_flows["a_snap"]["host_demoted_pages_total"] > 0
    assert port_flows["pages"] == jax_flows["pages"] > 0  # kill() left the pool


def test_shared_pool_promotes_after_kill_equal_jax(lm, jax_flows, port_flows):
    assert port_flows["b"] == jax_flows["b"] == flm.refs(lm.prefixed)
    snap = port_flows["b_snap"]
    assert snap["host_tier_hits_total"] > 0 and snap["host_promoted_pages_total"] > 0
    assert snap["host_quarantined_total"] == 0
    for key in ("host_tier_hits_total", "host_promoted_pages_total"):
        assert snap[key] == jax_flows["b_snap"][key], key


def test_corrupt_promote_quarantines_equal_jax(lm, jax_flows, port_flows):
    assert port_flows["c"] == jax_flows["c"] == flm.refs(lm.prefixed)
    snap = port_flows["c_snap"]
    assert snap["host_quarantined_total"] > 0 and snap["host_promoted_pages_total"] == 0
    assert snap["host_quarantined_total"] == jax_flows["c_snap"]["host_quarantined_total"]


def test_private_pool_promotes_after_tree_eviction_equal_jax(lm, jax_flows, port_flows):
    """A four-page tree cap evicts each prompt's deep page; the private
    pool holds it, so re-serving each prompt promotes instead of
    re-prefilling it, token-exact and with the JAX package's counts."""
    want = flm.refs(lm.prefixed)
    assert port_flows["d"] == jax_flows["d"] == want
    assert port_flows["d_again"] == jax_flows["d_again"] == want
    assert port_flows["d_private"] and jax_flows["d_private"]
    snap = port_flows["d_snap"]
    assert snap["host_tier_hits_total"] > 0 and snap["host_promoted_pages_total"] > 0
    for key in ("host_tier_hits_total", "host_promoted_pages_total", "host_demoted_pages_total"):
        assert snap[key] == jax_flows["d_snap"][key], key


def test_promoted_pages_are_tree_owned(lm):
    pool = HostPagePool(max_bytes=1 << 20, page_size=PS)
    ea = flm.port_engine(lm, pool=pool, base=flm.DC_PREFIX)
    try:
        _serve(ea, lm.prefixed)
    finally:
        ea.kill()
    eb = flm.port_engine(lm, pool=pool, base=flm.DC_PREFIX)
    try:
        _serve(eb, lm.prefixed)
        deadline = time.monotonic() + flm.WAIT_S
        while eb.load() > 0 and time.monotonic() < deadline:
            time.sleep(0.005)
        held = [r for r in eb.kv.allocator.refcounts()[1:] if r > 0]
        assert held and all(r == 1 for r in held) and len(held) == eb.prefix.num_pages
    finally:
        eb.close(timeout=flm.WAIT_S)
    eb.kv.assert_no_leaks()


def test_config_validation(lm, caplog):
    with pytest.raises(Exception, match="prefix_cache"):
        flm.port_engine(lm, host_tier_bytes=1 << 20)
    with pytest.raises(Exception, match="page_size"):
        flm.port_engine(lm, pool=HostPagePool(1 << 20, 8), base=flm.DC_PREFIX)
    # a speculative engine cannot adopt target-only pages: the tier is off
    from paddle_tpu_torch.serving import DecodeConfig, DecodeEngine

    eng = DecodeEngine(lm.params, lm.cfg, decode=DecodeConfig(**flm.DC_PREFIX),
                       draft_variables=lm.params, host_tier=HostPagePool(1 << 20, PS),
                       device="cpu")
    try:
        assert eng.host_tier is None
    finally:
        eng.close(timeout=flm.WAIT_S)


def test_prefix_aware_fleet_routing(lm):
    """Engine B warmed with one prompt: the fleet routes that prompt and
    its siblings sharing the system prefix to B by digest match."""
    ea = flm.port_engine(lm, label="route-a", base=flm.DC_PREFIX, prefix_digest=True)
    eb = flm.port_engine(lm, label="route-b", base=flm.DC_PREFIX, prefix_digest=True)
    fleet = DecodeFleet([ea, eb])
    try:
        prompt, n, ref = lm.prefixed[0]
        assert flm.tokens([eb.submit(prompt, n)]) == [ref.tolist()]
        deadline = time.monotonic() + flm.WAIT_S
        while not eb.prefix_digest() and time.monotonic() < deadline:
            time.sleep(0.005)
        assert eb.prefix_match_depth(prefix_digests(prompt, PS)) >= 14 // PS
        assert ea.prefix_match_depth(prefix_digests(prompt, PS)) == 0
        for p, _, _ in lm.prefixed[1:]:
            assert fleet._pick(prompt=p) is eb
        got = flm.tokens([fleet.submit(p, n) for p, n, _ in lm.prefixed[1:]])
        assert got == flm.refs(lm.prefixed[1:])
    finally:
        fleet.close(timeout=flm.WAIT_S)
