"""Page-level parity of the port's KV cache against the JAX reference's,
shared by the engine parity tests (`test_torch_kv_tier.py`,
`test_torch_prefix_cache.py`, `test_torch_overload.py`, ...).

A random tiny model's greedy streams barely depend on which KV a restore,
a COW copy or a swap-in put back, so these compare the pages themselves:
`assert_same_kv` every cached prefix page, wherever it lives, and
`capture_swap_ins` / `assert_same_swap_ins` a swapped slot's pages right
after its swap-in.  float32, 1e-4: the two frameworks compute the same KV
in other orders.
"""
import numpy as np

TOL = 1e-4


def node_kv(eng, node):
    """{leaf: [L, n_tokens, ...] numpy} of a cached prefix node, wherever
    it lives: the device pool, a host slab, or the store (read without
    touching the tier's counters)."""
    tier = eng.cache._tier
    if node.page >= 0:
        data = {n: np.asarray(a)[:, node.page] for n, a in eng._pool.items()}
    elif node.node_id in tier._disk:
        data = tier.store.get(tier._disk[node.node_id])
    else:
        data = tier._host[node.node_id]
        if data is tier._PENDING:
            return None
    return {n: np.asarray(a)[:, :node.n_tokens] for n, a in data.items()}


def assert_same_kv(ref, eng, tol=TOL):
    """The two caches index the same prefixes (the same keys, each on the
    device or off it alike), and each holds the reference's KV for its
    tokens."""
    rindex, index = ref.cache._index, eng.cache._index
    assert set(index) == set(rindex)
    for key, node in index.items():
        rnode = rindex[key]
        assert (node.page >= 0) == (rnode.page >= 0), key
        got, want = node_kv(eng, node), node_kv(ref, rnode)
        assert (got is None) == (want is None)
        for n in want or ():
            np.testing.assert_allclose(got[n], want[n], rtol=tol, atol=tol)


def capture_swap_ins(eng):
    """Wrap `eng._swap_in` (either framework's) so that each swap-in that
    lands records the slot's KV right after its scatter: returns the list
    the records go to, [(request id, {leaf: [L, tokens, ...]})]."""
    records = []
    inner = eng._swap_in

    def swap_in(req, rec, slot):
        ok = inner(req, rec, slot)
        if ok:
            n, length = rec["n"], rec["L"]
            pages = list(eng.cache.slot_pages(slot)[:n])
            kv = {}
            for name, a in eng._pool.items():
                a = np.asarray(a)[:, pages]     # [L, n, page, ...]
                kv[name] = a.reshape((a.shape[0], -1) + a.shape[3:])[
                    :, :length]
            records.append((req.request_id, kv))
        return ok
    eng._swap_in = swap_in
    return records


def assert_same_swap_ins(ref_records, records, tol=TOL):
    """The same swap-ins, in order, each slot holding the reference's KV
    for its tokens."""
    assert [r for r, _ in records] == [r for r, _ in ref_records]
    for (rid, got), (_, want) in zip(records, ref_records):
        assert set(got) == set(want), rid
        for n in want:
            np.testing.assert_allclose(got[n], want[n], rtol=tol, atol=tol,
                                       err_msg=f"request {rid} leaf {n}")
