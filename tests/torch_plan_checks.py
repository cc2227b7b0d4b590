"""The invariants that tie igmc_torch's block-aligned edge plans and its
blocked engine's plans to the JAX package's (imported by the port's test
files; not a test module itself).

The port sorts each scatter row's edges by relation ((dst, etype) in the
forward plan, (src, etype) in the twin), where JAX sorts by the scatter row
alone. So the two plans hold the same edges in the same chunks, rows and
slots, in another order within a row."""

import numpy as np


def assert_plan_matches_jax(got, want):
    """`got` and `want`: (gather, scatter_local, etype, mask, chunk_of_block,
    first_of_chunk, ukey or None) from the port and from JAX for the same
    edges.

    - scatter_local, mask, chunk_of_block and first_of_chunk equal JAX's
      exactly, and so do the padding slots;
    - each chunk holds the same multiset of (scatter row, etype, gather
      row, ukey) as JAX's: every edge keeps its relation and its key;
    - etype is nondecreasing within each scatter row's run of real slots.
    """
    assert len(got) == len(want) == 7
    assert (got[6] is None) == (want[6] is None)
    for g, w in zip(got, want):
        if g is not None:
            assert g.dtype == w.dtype and g.shape == w.shape
    for i in (1, 3, 4, 5):
        np.testing.assert_array_equal(got[i], want[i])
    gather, local, etype, mask, chunk = got[:5]
    ukey = got[6] if got[6] is not None else np.zeros_like(gather)
    wkey = want[6] if want[6] is not None else np.zeros_like(gather)
    real = mask != 0
    for g, w in ((gather, want[0]), (etype, want[2]), (ukey, wkey)):
        np.testing.assert_array_equal(g[~real], w[~real])   # padding

    eblk = gather.size // chunk.size
    slot_chunk = np.repeat(chunk, eblk)
    for c in np.unique(slot_chunk[real]):
        sel = real & (slot_chunk == c)
        rows_got = np.stack([local, etype, gather, ukey], 1)[sel]
        rows_want = np.stack([local, want[2], want[0], wkey], 1)[sel]
        np.testing.assert_array_equal(np.unique(rows_got, axis=0, return_counts=True)[1],
                                      np.unique(rows_want, axis=0, return_counts=True)[1])
        np.testing.assert_array_equal(np.unique(rows_got, axis=0),
                                      np.unique(rows_want, axis=0))

    idx = np.nonzero(real)[0]
    same_row = ((slot_chunk[idx[1:]] == slot_chunk[idx[:-1]])
                & (local[idx[1:]] == local[idx[:-1]]))
    assert (etype[idx[1:]][same_row] >= etype[idx[:-1]][same_row]).all()


def assert_blocked_plans_equal(J, P):
    """The blocked engine's plans: `P` (the port's BlockedEdges, CPU
    tensors) equals `J` (the JAX package's) field by field, dtypes
    included, in both directions, with the same geometry."""
    for name, a, b in zip(J.fwd._fields * 2, list(J.fwd) + list(J.bwd),
                          list(P.fwd) + list(P.bwd)):
        a = np.asarray(a)
        assert b.numpy().dtype == a.dtype and np.array_equal(b.numpy(), a), name
    assert (P.rows, P.num_nodes, P.group, P.num_gather) == (J.rows, J.num_nodes,
                                                           J.group, J.num_gather)
