"""The slot-grouped histograms of the port's tree engine on the CPU.

``group_rows`` (plain version) against a numpy stable argsort plus
bincount, exact. Then the grouped decomposition the CUDA kernels compute
(``csrc/grouped_hist.cuh``), written out in torch here: per chunk of the
grouped order (``group_chunk``) and per 16-row K-step, indicatorᵀ @
stats added into the partial of (chunk c, slot s) at index c + s, padded
K-steps included; each slot's partials summed in chunk order. It is held
against ``cumhist_reference``, ``cumhist_sparse01_reference``, the JAX
package's ``_treefit._level_cumhist`` and its Pallas ``cumhist`` in
interpret mode: within 1e-12 in f64; in f32 counts exact and weighted
channels within 1e-5 of the channel's max |value| (bf16-rounded products
summed in another order). The kernels themselves run only on the card
(``cuda`` marker)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmogrifai_tpu.models import _pallas_hist as JP
from transmogrifai_tpu.models import _treefit as JT
from transmogrifai_tpu_torch.models import _hist as H
from transmogrifai_tpu_torch.models import _treefit as PT

REL32 = 1e-5
TOL64 = 1e-12


def _numpy_groups(node, A):
    """Stable argsort + bincount, padded as ``group_rows`` documents."""
    n = len(node)
    live = (node >= 0) & (node < A)
    key = np.where(live, node, A)
    perm = np.argsort(key, kind="stable")
    cnt = np.bincount(key, minlength=A + 1)[:A]
    seg_off = np.concatenate([[0], np.cumsum((cnt + 15) // 16 * 16)])
    order = np.full(n + 15 * A, n, np.int32)
    sorted_live = perm[: int(cnt.sum())]
    for s in range(A):
        ids = sorted_live[key[sorted_live] == s]
        order[seg_off[s]:seg_off[s] + len(ids)] = ids
    return order, seg_off.astype(np.int32)


def _nodes(rng, n, A, case):
    node = rng.integers(0, A + 1, size=n).astype(np.int32)
    if case == "idle":
        node[:] = A
    elif case == "empty":                    # only even slots hold rows
        node = np.where(node % 2 == 1, A, node).astype(np.int32)
    return node


@pytest.mark.parametrize("A", [1, 8, 128])
@pytest.mark.parametrize("case", ["mixed", "idle", "empty"])
def test_group_rows_matches_numpy(rng, A, case):
    n = 1001
    node = _nodes(rng, n, A, case)
    order, seg_off = H.group_rows(torch.tensor(node), A)
    want_order, want_off = _numpy_groups(node, A)
    assert order.dtype == seg_off.dtype == torch.int32
    np.testing.assert_array_equal(order.numpy(), want_order)
    np.testing.assert_array_equal(seg_off.numpy(), want_off)
    o, so = order.numpy(), seg_off.numpy()
    assert (np.diff(so) % H.KSTEP == 0).all()
    for s in range(A):                        # live ids, then padding ids
        seg = o[so[s]:so[s + 1]]
        ids = seg[seg < n]
        assert (node[ids] == s).all() and (np.diff(ids) > 0).all()
        assert (seg[len(ids):] == n).all()
    assert (o[so[A]:] == n).all()


def test_group_chunk_is_a_function_of_shapes():
    for n, A in ((1, 1), (1001, 8), (200_000, 64), (120_000, 32)):
        chunk, n_chunks = H.group_chunk(n, A)
        assert chunk % 32 == 0 and chunk >= 64
        assert (n_chunks - 1) * chunk < n + 15 * A <= n_chunks * chunk


def _grouped(ind, st, node, A):
    """The kernels' decomposition: ``ind`` [n, M] indicator rows, ``st``
    [n, C] (already bf16-rounded in f32) → [A, M, C] per-slot sums."""
    n, M = ind.shape
    C = st.shape[1]
    order, seg_off = H.group_rows(node, A)
    order, seg_off = order.long(), seg_off.tolist()
    ind = torch.cat([ind, torch.zeros((1, M), dtype=ind.dtype)])  # id n
    st = torch.cat([st, torch.zeros((1, C), dtype=st.dtype)])
    chunk, n_chunks = H.group_chunk(n, A)
    total = seg_off[A]
    partial = torch.zeros((n_chunks + A, M, C), dtype=st.dtype)
    for c in range(n_chunks):
        s = 0
        for k0 in range(c * chunk, min(c * chunk + chunk, total), H.KSTEP):
            while seg_off[s + 1] <= k0:
                s += 1
            ids = order[k0:k0 + H.KSTEP]
            partial[c + s] += ind[ids].t() @ st[ids]
    out = torch.zeros((A, M, C), dtype=st.dtype)
    for s in range(A):
        lo, hi = seg_off[s], seg_off[s + 1]
        if hi > lo:
            for c in range(lo // chunk, (hi - 1) // chunk + 1):
                out[s] += partial[c + s]
    return out


def _st(stats):
    st = torch.tensor(stats)
    return st.to(torch.bfloat16).to(torch.float32) \
        if st.dtype == torch.float32 else st


def _grouped_cumhist(stats, node, Xb, A, B):
    n, F = Xb.shape
    thr = np.arange(B)
    ind = (Xb[:, None, :] <= thr[None, :, None]).reshape(n, B * F)
    st = _st(stats)
    out = _grouped(torch.tensor(ind).to(st.dtype), st, torch.tensor(node), A)
    return out.permute(0, 2, 1).reshape(A, -1, B, F).numpy()


def _grouped_bc(stats, node, Xb, A, B):
    """The precomputed kind: the indicator rows are the bytes of
    ``bc_rows``' copy of ``make_bc``, byte m = t·F + f, read as they are."""
    n, F = Xb.shape
    rows = H.bc_rows(H.make_bc(torch.tensor(Xb.T.copy()), B))
    st = _st(stats)
    out = _grouped(rows[:, :B * F].to(st.dtype), st, torch.tensor(node), A)
    return out.permute(0, 2, 1).reshape(A, -1, B, F).numpy()


def _grouped_sparse01(stats, node, X01, A):
    Fb, n = X01.shape
    st = _st(stats)
    ind = torch.tensor(np.concatenate([X01.T != 0, np.ones((n, 1), bool)],
                                      1)).to(st.dtype)
    h = _grouped(ind, st, torch.tensor(node), A).permute(0, 2, 1)
    tot = h[:, :, Fb:].expand(-1, -1, Fb)
    return torch.stack([tot - h[:, :, :Fb], tot], dim=2).numpy()


def _check32(out, refs, C):
    for ref in refs:
        np.testing.assert_array_equal(out[:, -1], ref[:, -1])
        for c in range(C - 1):
            scale = np.abs(ref[:, c]).max()
            assert np.abs(out[:, c] - ref[:, c]).max() <= REL32 * scale


def _inputs(rng, n, A, C, dtype):
    stats = rng.normal(size=(n, C)).astype(dtype)
    stats[:, -1] = rng.random(n) > 0.2                  # count channel
    return stats, _nodes(rng, n, A, "empty" if A == 8 else "mixed")


@pytest.mark.parametrize("A", [1, 8, 128])
@pytest.mark.parametrize("C", [3, 4])
def test_grouped_cumhist_f64_matches_references(rng, A, C):
    n, F, B = 1001, 5, 8
    stats, node = _inputs(rng, n, A, C, np.float64)
    Xb = rng.integers(0, B, size=(n, F)).astype(np.int32)
    got = _grouped_cumhist(stats, node, Xb, A, B)
    ref = H.cumhist_reference(torch.tensor(stats), torch.tensor(node),
                              torch.tensor(Xb.T.copy()), A, B).numpy()
    xla = np.asarray(JT._level_cumhist(jnp.asarray(stats), jnp.asarray(node),
                                       jnp.asarray(Xb), A, B))
    pal = np.asarray(JP.cumhist(jnp.asarray(stats), jnp.asarray(node),
                                jnp.asarray(Xb.T), A, B, interpret=True))
    for want in (ref, xla, pal):
        np.testing.assert_allclose(got, want, rtol=TOL64, atol=TOL64)


@pytest.mark.parametrize("A", [1, 8, 128])
@pytest.mark.parametrize("C", [3, 4])
def test_grouped_bc_f64_matches_references(rng, A, C):
    n, F, B = 1001, 5, 8
    stats, node = _inputs(rng, n, A, C, np.float64)
    Xb = rng.integers(0, B, size=(n, F)).astype(np.int32)
    got = _grouped_bc(stats, node, Xb, A, B)
    XbT = torch.tensor(Xb.T.copy())
    ref = H.cumhist_reference(torch.tensor(stats), torch.tensor(node), XbT,
                              A, B, bc=H.make_bc(XbT, B)).numpy()
    xla = np.asarray(JT._level_cumhist(jnp.asarray(stats), jnp.asarray(node),
                                       jnp.asarray(Xb), A, B))
    pal = np.asarray(JP.cumhist(
        jnp.asarray(stats), jnp.asarray(node), jnp.asarray(Xb.T), A, B,
        bc=JP.make_bc(jnp.asarray(Xb.T), B, jnp.float64), interpret=True))
    for want in (ref, xla, pal):
        np.testing.assert_allclose(got, want, rtol=TOL64, atol=TOL64)


@pytest.mark.parametrize("A", [1, 8, 128])
@pytest.mark.parametrize("C", [3, 4])
@pytest.mark.parametrize("Fb", [1, 7, 130])
def test_grouped_sparse01_f64_matches_references(rng, A, C, Fb):
    n = 1001
    stats, node = _inputs(rng, n, A, C, np.float64)
    X01 = (rng.random((Fb, n)) < 0.1).astype(np.int32)
    got = _grouped_sparse01(stats, node, X01, A)
    ref = H.cumhist_sparse01_reference(
        torch.tensor(stats), torch.tensor(node),
        torch.tensor(X01).to(torch.uint8), A).numpy()
    xla = np.asarray(JT._level_cumhist(jnp.asarray(stats), jnp.asarray(node),
                                       jnp.asarray(X01.T), A, 2))
    pal = np.asarray(JP.cumhist(jnp.asarray(stats), jnp.asarray(node),
                                jnp.asarray(X01), A, 2, sparse01=True,
                                interpret=True))
    assert got.shape == (A, C, 2, Fb)
    for want in (ref, xla, pal):
        np.testing.assert_allclose(got, want, rtol=TOL64, atol=TOL64)


@pytest.mark.parametrize("A,C", [(1, 3), (8, 4), (128, 4)])
def test_grouped_f32_counts_exact_weighted_close(rng, A, C):
    n, F, B, Fb = 2001, 4, 16, 130
    stats, node = _inputs(rng, n, A, C, np.float32)
    Xb = rng.integers(0, B, size=(n, F)).astype(np.int32)
    X01 = (rng.random((Fb, n)) < 0.05).astype(np.int32)
    got = _grouped_cumhist(stats, node, Xb, A, B)
    assert got.dtype == np.float32
    xla = np.asarray(JT._level_cumhist(jnp.asarray(stats), jnp.asarray(node),
                                       jnp.asarray(Xb), A, B))
    ref = H.cumhist_reference(torch.tensor(stats), torch.tensor(node),
                              torch.tensor(Xb.T.copy()), A, B).numpy()
    _check32(got, (ref, xla), C)
    got_bc = _grouped_bc(stats, node, Xb, A, B)
    assert got_bc.dtype == np.float32
    _check32(got_bc, (ref, xla), C)
    got01 = _grouped_sparse01(stats, node, X01, A)
    ref01 = H.cumhist_sparse01_reference(
        torch.tensor(stats), torch.tensor(node),
        torch.tensor(X01).to(torch.uint8), A).numpy()
    pal01 = np.asarray(JP.cumhist(jnp.asarray(stats), jnp.asarray(node),
                                  jnp.asarray(X01), A, 2, sparse01=True,
                                  interpret=True))
    _check32(got01, (ref01, pal01), C)


@pytest.mark.parametrize("F,Fb,F_pad,Fb_pad", [(20, 7, 32, 16),
                                               (1100, 1500, 1104, 1504)])
def test_row_major_copies(F, Fb, F_pad, Fb_pad):
    rng = np.random.default_rng(7)
    XbT = torch.tensor(rng.integers(0, 32, size=(F, 37)).astype(np.int32))
    rows = H.hist_rows(XbT)
    assert rows.dtype == torch.uint8 and rows.shape == (37, F_pad)
    np.testing.assert_array_equal(rows[:, :F].numpy(), XbT.numpy().T)
    assert not rows[:, F:].any()
    X01 = torch.tensor((rng.random((Fb, 37)) < 0.3).astype(np.uint8) * 3)
    rows01 = H.sparse01_rows(X01)
    assert rows01.shape == (37, Fb_pad)
    np.testing.assert_array_equal(rows01[:, :Fb].numpy(), X01.numpy().T != 0)
    assert (rows01[:, Fb] == 1).all() and not rows01[:, Fb + 1:].any()


@pytest.mark.parametrize("F,B,pad", [(20, 32, 640), (5, 3, 16),
                                     (419, 2, 848)])
def test_bc_rows_is_the_padded_transpose(F, B, pad):
    rng = np.random.default_rng(9)
    XbT = torch.tensor(rng.integers(0, B, size=(F, 37)).astype(np.int32))
    bc = H.make_bc(XbT, B)
    rows = H.bc_rows(bc)
    assert rows.dtype == torch.uint8 and rows.shape == (37, pad)
    np.testing.assert_array_equal(rows[:, :B * F].numpy(), bc.numpy().T)
    assert not rows[:, B * F:].any()


def _mixed_fit_inputs(rng, n, dev, dtype):
    X = np.concatenate([rng.normal(size=(n, 3)),
                        (rng.random((n, 4)) < 0.3) * 1.0], 1)
    mask = np.array([False] * 3 + [True] * 4)
    XbT, edges = PT.compute_bins(torch.tensor(X, device=dev, dtype=dtype),
                                 32, binary_mask=mask)
    y = torch.tensor((X[:, 0] > 0), device=dev, dtype=dtype)
    one = torch.ones(n, device=dev, dtype=dtype)
    return XbT, edges, mask, torch.stack([one, y, y, one], 1)


def _level_group_calls(monkeypatch, XbT, edges, mask, stats):
    """The slot counts ``grow_tree`` groups rows for, per driver."""
    calls = []

    def counting(node, A):
        calls.append(A)
        return H.group_rows(node, A)
    monkeypatch.setattr(PT, "group_rows", counting)
    blocks = PT.prepare_blocks(XbT, 32, mask)
    got = []
    for unroll in (False, True):
        calls.clear()
        PT.grow_tree(XbT, edges, stats, PT.VarianceCriterion(),
                     PT.variance_leaf, 3, 32, 5.0, 0.0, unroll=unroll,
                     blocks=blocks)
        got.append(list(calls))
    return blocks, got


def test_level_loop_groups_rows_once_per_level(rng, monkeypatch):
    """The CPU's plain histograms read the [F, n] bins: its blocks hold
    no row-major copy and no level groups rows (on the card each level
    groups them once: the ``cuda`` twin below)."""
    blocks, got = _level_group_calls(
        monkeypatch, *_mixed_fit_inputs(rng, 300, "cpu", torch.float64))
    assert all(b.rows is None for b in blocks)
    assert got == [[], []]


@pytest.mark.cuda
def test_level_loop_groups_rows_once_per_level_on_the_card(rng, monkeypatch):
    """One ``group_rows`` per level on the card, shared by both blocks'
    histograms, whose row-major copies the fit made once."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA GPU present: the kernels run only on the card")
    blocks, got = _level_group_calls(
        monkeypatch, *_mixed_fit_inputs(rng, 300, "cuda", torch.float32))
    assert all(b.rows is not None for b in blocks)
    assert got == [[4] * 3, [1, 1, 2]]


@pytest.mark.cuda
@pytest.mark.parametrize("F,B,Fb", [
    (5, 8, 1), (5, 8, 7), (5, 8, 130),
    # several groups of output rows (one group is up to 1,024 of them),
    # rows wider than a group reads; at B = 1 the widest groups take
    # fewer m-tiles a warp
    (40, 32, 1500), (600, 32, 1500), (1100, 2, 1500), (600, 1, 1500)])
def test_grouped_kernels_match_plain_versions_on_the_card(F, B, Fb):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA GPU present: the kernels run only on the card")
    rng = np.random.default_rng(11)
    dev = torch.device("cuda")
    n = 1001
    for A in (1, 8, 128):
        for case in ("mixed", "idle", "empty"):
            node = torch.tensor(_nodes(rng, n, A, case), device=dev)
            for a, b in zip(H.group_rows(node, A),
                            H.group_rows_reference(node, A)):
                assert torch.equal(a, b)
        for C in (3, 4):
            stats, node = _inputs(rng, n, A, C, np.float32)
            st, nd = (torch.tensor(a, device=dev) for a in (stats, node))
            X01 = torch.tensor((rng.random((Fb, n)) < 0.1).astype(np.uint8),
                               device=dev)
            Xb = torch.tensor(rng.integers(0, B, size=(F, n))
                              .astype(np.int32), device=dev)
            for fn, refs in (
                    (lambda: H.cumhist_sparse01(st, nd, X01, A),
                     [H.cumhist_sparse01_reference(st, nd, X01, A),
                      H.cumhist_reference(st, nd, X01.to(torch.int32), A,
                                          2)]),
                    (lambda: H.cumhist(st, nd, Xb, A, B),
                     [H.cumhist_reference(st, nd, Xb, A, B)])):
                out = fn()
                assert torch.equal(out, fn())              # bitwise repeat
                for ref in refs:
                    assert torch.equal(out[:, -1], ref[:, -1])
                for c in range(C - 1):
                    assert (out[:, c] - refs[0][:, c]).abs().max() \
                        <= REL32 * refs[0][:, c].abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("F,B", [(20, 32), (5, 8),
                                 # B·F = 1,280: two groups of output rows
                                 (40, 32)])
def test_cumhist_bc_kernel_matches_plain_version_on_the_card(F, B):
    """The twin of ``chip_smoke.py``'s ``cumhist(bc=)`` check: counts
    exact against both plain versions, weighted channels within 2e-5 of
    the channel's max |value|, two calls bitwise equal, zeros from
    all-idle rows."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA GPU present: the kernels run only on the card")
    rng = np.random.default_rng(13)
    dev = torch.device("cuda")
    n = 2001
    Xb = torch.tensor(rng.integers(0, B, size=(F, n)).astype(np.int32),
                      device=dev)
    bc = H.make_bc(Xb, B)
    rows = H.bc_rows(bc)
    for A in (1, 64, 128):
        for C in (3, 4):
            stats, node = _inputs(rng, n, A, C, np.float32)
            st, nd = (torch.tensor(a, device=dev) for a in (stats, node))
            out = H.cumhist(st, nd, Xb, A, B, bc=bc, rows=rows,
                            groups=H.group_rows(nd, A))
            assert torch.equal(out, H.cumhist(st, nd, Xb, A, B, bc=bc))
            refs = [H.cumhist_reference(st, nd, Xb, A, B, bc=bc),
                    H.cumhist_reference(st, nd, Xb, A, B)]
            for ref in refs:
                assert torch.equal(out[:, -1], ref[:, -1])
            for c in range(C - 1):
                assert (out[:, c] - refs[0][:, c]).abs().max() \
                    <= 2e-5 * refs[0][:, c].abs().max()
    idle = torch.full((n,), 64, dtype=torch.int32, device=dev)
    assert not H.cumhist(st, idle, Xb, 64, B, bc=bc, rows=rows).any()
