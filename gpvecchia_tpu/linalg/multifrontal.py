"""Geometric nested-dissection multifrontal Cholesky for W = sum_e u_e u_e^T + D.

The Vecchia posterior precision W = U_y U_y^T + D is a sum of rank-1
"element" outer products — one per Vecchia column (its latent-conditioned
entries) — plus a diagonal.  Its log-determinant, quadratic forms z^T W^{-1} z,
solves W^{-1} b and the inverse diagonal diag(W^{-1}) are all invariant under
symmetric permutation, so the elimination ordering is a free parameter.  This
module exploits that: elements are partitioned into a balanced binary spatial
tree (median splits of their locations), vertices are assigned to the lowest
common ancestor of the leaves whose elements touch them, and the factorization
proceeds level-by-level from the leaves:

  * leaf fronts assemble their elements as localized dense columns U_loc and
    one batched GEMM  front = U_loc U_loc^T,
  * internal fronts extend-add their two children's Schur updates with static
    gather maps (scatter-free),
  * each level runs ONE batched blocked dense Cholesky + TRSM + SYRK
    (linalg/blocked.py), and the Schur complements pass up the tree.

This replaces the reference's sequential sparse Cholesky `Matrix::chol` /
`ic0` hot spot (/root/reference/R/vecchia_prediction.R:74-84,
/root/reference/src/ic0.cpp:43-64) with ~log2(n) levels of dense batched
compute; the right-hand side z2 = U_y z1 is never materialized globally —
per-leaf partial RHS vectors b = U_loc z1 ride the same tree, so the former
scatter/gather pair-product schedules disappear from the hot path entirely.

Everything on device is pure jnp (differentiable); the planner is
parameter-free NumPy run once per spec.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

import jax
import jax.numpy as jnp

from .blocked import (chol, lower_solve_vec, tri_inv_lower, trsm_right,
                      upper_solve_vec)
from ..utils.runtime import memory_budget

__all__ = ["MFPlan", "build_mf_plan", "mf_device_arrays", "mf_factor",
           "mf_forward", "mf_backward", "mf_solve", "mf_selinv_diag"]

_PREC = jax.lax.Precision.HIGHEST


# --------------------------------------------------------------------------
# host-side planner
# --------------------------------------------------------------------------

@dataclasses.dataclass
class MFLevel:
    """Padded per-depth node arrays (N = 2**depth nodes at this depth)."""
    npiv: int                    # P: padded pivot count per node
    nbord: int                   # B: padded border count per node
    piv_ids: np.ndarray          # (N, P) int32 vertex ids, -1 pad
    ext: np.ndarray | None       # (N, 2, F) parent-front pos -> child border pos
    bord_in_parent: np.ndarray | None  # (N, B) border pos -> parent front pos
    bord_x_slot: np.ndarray | None     # (N, B) flat x slot of border verts
    elem_pt: np.ndarray | None   # leaves only: (N, EL) element ids, -1 pad
    elem_pos: np.ndarray | None  # leaves only: (N, EL, K) front positions, -1

    @property
    def front(self):
        return self.npiv + self.nbord


@dataclasses.dataclass
class MFPlan:
    n_vert: int
    depth: int                   # leaves at depth D, root at 0
    levels: list                 # MFLevel, indexed by depth 0..D
    x_offsets: np.ndarray        # (D+1,) flat x offset of each level's pivots
    x_size: int
    x_slot: np.ndarray           # (n_vert,) flat x slot of each vertex (unique)


def _median_split_tree(xy, depth):
    """Leaf index (in-order, 0..2**depth-1) per element via median splits."""
    E = xy.shape[0]
    leaf = np.zeros(E, dtype=np.int64)
    if depth == 0:
        return leaf

    def rec(ids, d, node):
        if d == depth:
            leaf[ids] = node
            return
        sub = xy[ids]
        dim = int(np.argmax(sub.max(axis=0) - sub.min(axis=0)))
        order = np.argsort(sub[:, dim], kind="stable")
        h = ids.size // 2
        rec(ids[order[:h]], d + 1, node * 2)
        rec(ids[order[h:]], d + 1, node * 2 + 1)

    rec(np.arange(E), 0, 0)
    return leaf


def build_mf_plan(elem_verts, elem_xy, n_vert, leaf_elems=96,
                  max_depth=None) -> MFPlan:
    """Build the multifrontal plan.

    elem_verts: (E, K) int vertex ids per element, -1 padded.
    elem_xy:    (E, d) element locations (used only for partitioning).
    Every vertex in [0, n_vert) must appear in at least one element.
    """
    elem_verts = np.asarray(elem_verts, dtype=np.int64)
    E, K = elem_verts.shape
    D = max(int(np.ceil(np.log2(max(E, 1) / max(leaf_elems, 1)))), 0)
    if max_depth is not None:
        D = min(D, max_depth)
    while D > 0 and (1 << D) > E:
        D -= 1
    leaf_of_elem = _median_split_tree(np.asarray(elem_xy, np.float64), D)

    # ---- vertex -> tree node (LCA of element leaves, via min/max leaf) ----
    ev_ok = elem_verts >= 0
    flat_v = elem_verts[ev_ok]
    flat_leaf = np.broadcast_to(leaf_of_elem[:, None], (E, K))[ev_ok]
    vmin = np.full(n_vert, np.iinfo(np.int64).max)
    vmax = np.full(n_vert, -1, dtype=np.int64)
    np.minimum.at(vmin, flat_v, flat_leaf)
    np.maximum.at(vmax, flat_v, flat_leaf)
    if np.any(vmax < 0):
        raise ValueError("multifrontal plan: vertex appears in no element")
    xdiff = vmin ^ vmax
    h = np.zeros(n_vert, dtype=np.int64)
    nz = xdiff > 0
    h[nz] = np.floor(np.log2(xdiff[nz])).astype(np.int64) + 1
    vdepth = D - h
    vnode = vmin >> h            # node index at depth vdepth

    # ---- elimination order: deepest nodes first, in-order within level ----
    order = np.lexsort((np.arange(n_vert), vnode, -vdepth))
    elim = np.empty(n_vert, dtype=np.int64)
    elim[order] = np.arange(n_vert)

    base = (1 << np.arange(D + 2)) - 1          # flat node id offset by depth
    gid = base[vdepth] + vnode
    n_nodes = base[D + 1]
    piv_count = np.bincount(gid, minlength=n_nodes)
    node_order = np.concatenate(
        [base[d] + np.arange(1 << d) for d in range(D, -1, -1)])
    starts = np.zeros(n_nodes, dtype=np.int64)
    starts[node_order] = np.concatenate(
        [[0], np.cumsum(piv_count[node_order])[:-1]])

    def pivots_of(d, i):
        g = base[d] + i
        s = starts[g]
        return order[s:s + piv_count[g]]        # vertex ids, elim-ascending

    # ---- borders bottom-up (vertex ids sorted by elimination index) ----
    borders = [None] * n_nodes
    leaf_sort = np.argsort(leaf_of_elem, kind="stable")
    leaf_cnt = np.bincount(leaf_of_elem, minlength=1 << D)
    leaf_off = np.concatenate([[0], np.cumsum(leaf_cnt)])

    for i in range(1 << D):
        elems = leaf_sort[leaf_off[i]:leaf_off[i + 1]]
        verts = elem_verts[elems]
        verts = np.unique(verts[verts >= 0])
        b = verts[gid[verts] != base[D] + i]
        borders[base[D] + i] = b[np.argsort(elim[b])]
    for d in range(D - 1, -1, -1):
        for i in range(1 << d):
            g = base[d] + i
            b = np.union1d(borders[base[d + 1] + 2 * i],
                           borders[base[d + 1] + 2 * i + 1])
            b = b[gid[b] != g]
            borders[g] = b[np.argsort(elim[b])]
    assert borders[0].size == 0, "root border must be empty"

    # ---- padded per-level arrays ----
    levels = []
    piv_lists = []
    for d in range(D + 1):
        N = 1 << d
        pivs = [pivots_of(d, i) for i in range(N)]
        piv_lists.append(pivs)
        P = max((p.size for p in pivs), default=0)
        B = max((borders[base[d] + i].size for i in range(N)), default=0)
        piv_ids = np.full((N, P), -1, dtype=np.int64)
        for i, p in enumerate(pivs):
            piv_ids[i, :p.size] = p
        levels.append(MFLevel(npiv=P, nbord=B,
                              piv_ids=piv_ids.astype(np.int32),
                              ext=None, bord_in_parent=None, bord_x_slot=None,
                              elem_pt=None, elem_pos=None))

    def front_padded(d, i):
        """PADDED front vertex ids of node (d, i): (F,), -1 at pad slots."""
        lv = levels[d]
        f = np.full(lv.front, -1, dtype=np.int64)
        p = piv_lists[d][i]
        b = borders[base[d] + i]
        f[:p.size] = p
        f[lv.npiv:lv.npiv + b.size] = b
        return f

    def pos_in(sorted_ids, query):
        """Positions of query ids within an elim-sorted id list (-1 = miss)."""
        keys = elim[sorted_ids] if sorted_ids.size else np.empty(0, np.int64)
        q = elim[query]
        pos = np.searchsorted(keys, q)
        pos_c = np.minimum(pos, max(keys.size - 1, 0))
        ok = (keys[pos_c] == q) if keys.size else np.zeros(q.shape, bool)
        return np.where(ok, pos_c, -1)

    # ext maps (parent-front pos -> child border pos), internal levels
    for d in range(D):
        lv = levels[d]
        N = 1 << d
        F = lv.front
        ext = np.full((N, 2, F), -1, dtype=np.int64)
        for i in range(N):
            fv = front_padded(d, i)
            okf = fv >= 0
            for s in (0, 1):
                cb = borders[base[d + 1] + 2 * i + s]
                ext[i, s, okf] = pos_in(cb, fv[okf])
        lv.ext = ext.astype(np.int32)

    # ---- flat x layout: level-major (root first), (N, P) row-major ----
    x_offsets = np.zeros(D + 1, dtype=np.int64)
    pos = 0
    for d in range(D + 1):
        x_offsets[d] = pos
        pos += (1 << d) * levels[d].npiv
    x_slot = np.full(n_vert, -1, dtype=np.int64)
    for d in range(D + 1):
        lv = levels[d]
        ok = lv.piv_ids >= 0
        slots = (x_offsets[d]
                 + np.arange(1 << d)[:, None] * max(lv.npiv, 1)
                 + np.arange(lv.npiv)[None, :])
        x_slot[lv.piv_ids[ok]] = slots[ok]
    assert np.all(x_slot >= 0)

    # bord_in_parent + bord_x_slot, levels 1..D
    for d in range(1, D + 1):
        lv = levels[d]
        N = 1 << d
        B = lv.nbord
        bip = np.full((N, B), -1, dtype=np.int64)
        bxs = np.full((N, B), -1, dtype=np.int64)
        Pp = levels[d - 1].npiv
        for i in range(N):
            b = borders[base[d] + i]
            if b.size == 0:
                continue
            ppiv = piv_lists[d - 1][i // 2]
            pbord = borders[base[d - 1] + i // 2]
            pp = pos_in(ppiv, b)
            pb = pos_in(pbord, b)
            assert np.all((pp >= 0) | (pb >= 0)), \
                "child border vertex missing from parent front"
            bip[i, :b.size] = np.where(pp >= 0, pp, Pp + pb)
            bxs[i, :b.size] = x_slot[b]
        lv.bord_in_parent = bip.astype(np.int32)
        lv.bord_x_slot = bxs.astype(np.int32)

    # leaf element maps
    lvD = levels[D]
    EL = int(leaf_cnt.max()) if leaf_cnt.size else 0
    NL = 1 << D
    elem_pt = np.full((NL, EL), -1, dtype=np.int64)
    elem_pos = np.full((NL, EL, K), -1, dtype=np.int64)
    for i in range(NL):
        elems = leaf_sort[leaf_off[i]:leaf_off[i + 1]]
        elem_pt[i, :elems.size] = elems
        fv = front_padded(D, i)
        okf = fv >= 0
        real = fv[okf]
        padded_pos = np.flatnonzero(okf)
        vv = elem_verts[elems]
        okv = vv >= 0
        safe = np.where(okv, vv, real[0] if real.size else 0)
        p = pos_in(real, safe)
        assert np.all(p[okv] >= 0), "element vertex missing from leaf front"
        elem_pos[i, :elems.size] = np.where(
            okv, padded_pos[np.maximum(p, 0)], -1)
    lvD.elem_pt = elem_pt.astype(np.int32)
    lvD.elem_pos = elem_pos.astype(np.int32)

    return MFPlan(n_vert=n_vert, depth=D, levels=levels,
                  x_offsets=x_offsets, x_size=int(pos), x_slot=x_slot)


# --------------------------------------------------------------------------
# device numerics
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MFStatic:
    """Static shape metadata (close over this; never pass through jit)."""
    depth: int
    npiv: tuple
    nbord: tuple
    x_offsets: tuple
    x_size: int
    n_vert: int


def mf_device_arrays(mf: MFPlan):
    """(static, arrays): shape metadata + jnp index-array pytree.

    `arrays` contains only jnp arrays (and Nones) and must be passed through
    the caller's jit boundary as an ARGUMENT; `static` holds Python ints used
    for slicing and must be closed over.
    """
    out = []
    for lv in mf.levels:
        out.append(dict(
            piv_ids=jnp.asarray(lv.piv_ids),
            ext=None if lv.ext is None else jnp.asarray(lv.ext),
            bip=(None if lv.bord_in_parent is None
                 else jnp.asarray(lv.bord_in_parent)),
            bxs=(None if lv.bord_x_slot is None
                 else jnp.asarray(lv.bord_x_slot)),
            elem_pt=None if lv.elem_pt is None else jnp.asarray(lv.elem_pt),
            elem_pos=(None if lv.elem_pos is None
                      else jnp.asarray(lv.elem_pos)),
        ))
    static = MFStatic(depth=mf.depth,
                      npiv=tuple(lv.npiv for lv in mf.levels),
                      nbord=tuple(lv.nbord for lv in mf.levels),
                      x_offsets=tuple(int(o) for o in mf.x_offsets),
                      x_size=int(mf.x_size), n_vert=int(mf.n_vert))
    arrays = dict(levels=out, x_slot=jnp.asarray(mf.x_slot))
    return static, arrays


def _leaf_uloc_raw(lvdev, F, u_vals, dt):
    """Localized element columns per leaf: (N, EL, F), scatter-free."""
    ept = lvdev["elem_pt"]
    epos = lvdev["elem_pos"]
    K = epos.shape[-1]
    u = jnp.where((ept >= 0)[..., None],
                  u_vals[jnp.clip(ept, 0)], 0.0).astype(dt)   # (N, EL, K)
    iota = jax.lax.broadcasted_iota(jnp.int32, (1, 1, F), 2)
    u_loc = jnp.zeros(ept.shape + (F,), dt)
    for k in range(K):
        u_loc = u_loc + jnp.where(iota == epos[..., k:k + 1],
                                  u[..., k:k + 1], 0.0)
    return u_loc


@functools.partial(jax.custom_vjp, nondiff_argnums=(0, 1))
def _leaf_uloc_cv(F, dt, ept, epos, u_vals):
    return _leaf_uloc_raw(dict(elem_pt=ept, elem_pos=epos), F, u_vals, dt)


def _leaf_uloc_fwd(F, dt, ept, epos, u_vals):
    return _leaf_uloc_cv(F, dt, ept, epos, u_vals), (ept, epos, u_vals)


def _leaf_uloc_bwd(F, dt, res, g):
    # du[e, k] = g[n, e, epos[e, k]]  (front = uloc-driven downstream)
    ept, epos, u_vals = res
    K = epos.shape[-1]
    E = u_vals.shape[0]
    ar_n = jnp.arange(g.shape[0])[:, None]
    ar_e = jnp.arange(g.shape[1])[None, :]
    du_loc = jnp.stack(
        [g[ar_n, ar_e, jnp.clip(epos[..., k], 0)] for k in range(K)],
        axis=-1)                                              # (N, EL, K)
    du_loc = jnp.where((epos >= 0) & (ept >= 0)[..., None], du_loc, 0.0)
    du = jnp.zeros((E + 1, K), g.dtype).at[
        jnp.where(ept >= 0, ept, E).reshape(-1)].add(
        du_loc.reshape(-1, K), mode="drop")
    return (np.zeros(ept.shape, jax.dtypes.float0),
            np.zeros(epos.shape, jax.dtypes.float0),
            du[:E].astype(u_vals.dtype))


_leaf_uloc_cv.defvjp(_leaf_uloc_fwd, _leaf_uloc_bwd)


def _leaf_uloc(lvdev, F, u_vals, dt):
    """_leaf_uloc_raw with a custom VJP whose only residual is u_vals
    (+ the index plans).

    Autodiff of the K-term one-hot expansion saves O(N * EL * F) select
    masks per term, which is what OOM'd jax.grad of the n=1e6/m=40
    likelihood (round-4 verdict item 2); the backward here is K small
    row-indexed gathers plus one segment scatter-add.
    """
    return _leaf_uloc_cv(F, dt, lvdev["elem_pt"], lvdev["elem_pos"], u_vals)


def _gather_elem(lvdev, vec, dt):
    """vec[elem_pt] with -1 pads -> 0; (N, EL)."""
    ept = lvdev["elem_pt"]
    return jnp.where(ept >= 0, vec[jnp.clip(ept, 0)], 0.0).astype(dt)


def _extend_add_mat(lvdev, F, upd, dt):
    """Gather the two children's Schur updates into parent fronts (N, F, F).

    Implemented as two ROW-granular gathers with a transpose in between
    (updr is symmetric, so gathering rows twice lands the (f1, f2) entry at
    updr[g[f1], g[f2]]).
    """
    N = lvdev["piv_ids"].shape[0]
    Bc = upd.shape[-1]
    updr = upd.reshape(N, 2, Bc, Bc)
    front = jnp.zeros((N, F, F), dt)
    ar = jnp.arange(N)[:, None]
    for s in (0, 1):
        g = lvdev["ext"][:, s, :]                   # (N, F)
        ok = g >= 0
        gc = jnp.clip(g, 0)
        rows = updr[:, s][ar, gc]                   # (N, F, Bc) row gather
        rows = jnp.where(ok[:, :, None], rows, 0.0)
        rows_t = jnp.swapaxes(rows, 1, 2)           # (N, Bc, F)
        sub = rows_t[ar, gc]                        # (N, F, F) row gather
        front = front + jnp.where(ok[:, :, None], sub, 0.0)
    return front


def _extend_add_vec(lvdev, F, bupd, dt):
    """Gather the two children's RHS updates into parent fronts (N, F)."""
    N = lvdev["piv_ids"].shape[0]
    Bc = bupd.shape[-1]
    bupdr = bupd.reshape(N, 2, Bc)
    b = jnp.zeros((N, F), dt)
    for s in (0, 1):
        g = lvdev["ext"][:, s, :]
        ok = g >= 0
        gc = jnp.clip(g, 0)
        vb = bupdr[:, s][jnp.arange(N)[:, None], gc]
        b = b + jnp.where(ok, vb, 0.0)
    return b


def _piv_gather(lvdev, vec, fill, F, dt):
    """(N, F): vec gathered at pivot ids (pads -> fill), zeros on border."""
    piv = lvdev["piv_ids"]
    N, P = piv.shape
    pok = piv >= 0
    v = jnp.where(pok, vec[jnp.clip(piv, 0)].astype(dt), fill)
    return jnp.concatenate([v, jnp.zeros((N, F - P), dt)], axis=-1)


def _factor_level(front, P, B):
    """(L_pp, L_bp) for one level's fronts: batched cholesky + trsm."""
    L_pp = chol(front[:, :P, :P])
    if B > 0:
        L_bp = trsm_right(front[:, P:, :P], L_pp)
    else:
        L_bp = jnp.zeros(front.shape[:-2] + (0, P), front.dtype)
    return L_pp, L_bp


def mf_factor(static, mfdev, u_vals, dvec, rhs_elem=None, rhs_vert=None,
              dtype=None, leaf_chunks=1):
    """Factor W = sum_e u_e u_e^T + diag(dvec), optionally solving forward.

    u_vals: (E, K) element values aligned with the plan's elem_verts
            (invalid slots must carry 0).
    dvec:   (n_vert,) diagonal additions.
    rhs_elem: optional (E,) per-element weights — the forward-solve RHS is
            b = sum_e rhs_elem[e] * u_e (+ rhs_vert), never materialized
            globally.
    rhs_vert: optional (n_vert,) direct RHS additions at vertices.

    Returns dict with 'logdet' (= log det W), per-level 'L_pp'/'L_bp', and
    (if an RHS was given) 'quad' = b^T W^{-1} b and per-level 'y' for
    mf_backward.  Padded pivots factor as exact 1s, so their log-diag and
    solve contributions vanish.
    """
    dt = dtype if dtype is not None else u_vals.dtype
    levels = mfdev["levels"]
    D = static.depth
    out = dict(L_pp=[None] * (D + 1), L_bp=[None] * (D + 1))
    want_rhs = rhs_elem is not None or rhs_vert is not None
    if want_rhs:
        out["y"] = [None] * (D + 1)
    logdet = jnp.zeros((), dt)
    quad = jnp.zeros((), dt)
    upd = None
    bupd = None
    for d in range(D, -1, -1):
        with jax.named_scope(f"mf_level_{d}"):
            lv = levels[d]
            P = static.npiv[d]
            B = static.nbord[d]
            F = P + B
            N = lv["piv_ids"].shape[0]

            if d == D:
                nchunk = (leaf_chunks
                          if leaf_chunks > 1 and N % leaf_chunks == 0 else 1)
                if nchunk > 1:
                    # sequential leaf chunks bound the (N, EL, F) localized
                    # column intermediate (3.5 GB at n=1e6/m=40 otherwise);
                    # assembly, diagonal add AND factorization run per
                    # chunk, so the full (N, F, F) leaf front (5.6 GB) never
                    # materializes — only the factor outputs persist
                    ept_r = lv["elem_pt"].reshape(nchunk, N // nchunk, -1)
                    epos_r = lv["elem_pos"].reshape(
                        nchunk, N // nchunk, ept_r.shape[-1], -1)
                    piv_r = lv["piv_ids"].reshape(nchunk, N // nchunk, -1)

                    def leaf_body(args):
                        ch = dict(elem_pt=args[0], elem_pos=args[1],
                                  piv_ids=args[2])
                        ul = _leaf_uloc(ch, F, u_vals, dt)
                        fr = jnp.einsum("nef,neg->nfg", ul, ul,
                                        precision=_PREC)
                        df = _piv_gather(ch, dvec, 1.0, F, dt)
                        fr = fr + df[:, :, None] * jnp.eye(F, dtype=dt)
                        if rhs_elem is not None:
                            re = _gather_elem(ch, rhs_elem, dt)
                            bb = jnp.einsum("nef,ne->nf", ul, re,
                                            precision=_PREC)
                        else:
                            bb = jnp.zeros((ul.shape[0], F), dt)
                        if want_rhs and rhs_vert is not None:
                            bb = bb + _piv_gather(ch, rhs_vert, 0.0, F, dt)
                        Lpp_c, Lbp_c = _factor_level(fr, P, B)
                        if want_rhs:
                            y_c = lower_solve_vec(Lpp_c, bb[:, :P])
                        else:
                            y_c = jnp.zeros((ul.shape[0], 0), dt)
                        upd_c = fr[:, P:, P:] - jnp.einsum(
                            "nbp,ncp->nbc", Lbp_c, Lbp_c, precision=_PREC)
                        bupd_c = bb[:, P:] - (jnp.einsum(
                            "nbp,np->nb", Lbp_c, y_c, precision=_PREC)
                            if want_rhs else 0.0)
                        return Lpp_c, Lbp_c, y_c, upd_c, bupd_c

                    Lpp_s, Lbp_s, y_s, upd_s, bupd_s = jax.lax.map(
                        leaf_body, (ept_r, epos_r, piv_r))
                    L_pp = Lpp_s.reshape(N, P, P)
                    L_bp = Lbp_s.reshape(N, B, P)
                    dg = jnp.diagonal(L_pp, axis1=-2, axis2=-1)
                    logdet = logdet + 2.0 * jnp.sum(jnp.log(dg))
                    out["L_pp"][d] = L_pp
                    out["L_bp"][d] = L_bp
                    upd = upd_s.reshape(N, B, B)
                    bupd = bupd_s.reshape(N, B)
                    if want_rhs:
                        y = y_s.reshape(N, P)
                        out["y"][d] = y
                        quad = quad + jnp.sum(y * y)
                    continue
                else:
                    u_loc = _leaf_uloc(lv, F, u_vals, dt)
                    front = jnp.einsum("nef,neg->nfg", u_loc, u_loc,
                                       precision=_PREC)
                    if want_rhs:
                        b = jnp.zeros((N, F), dt)
                        if rhs_elem is not None:
                            re = _gather_elem(lv, rhs_elem, dt)
                            b = b + jnp.einsum("nef,ne->nf", u_loc, re,
                                               precision=_PREC)
            else:
                front = _extend_add_mat(lv, F, upd, dt)
                if want_rhs:
                    b = _extend_add_vec(lv, F, bupd, dt)

            dfull = _piv_gather(lv, dvec, 1.0, F, dt)
            front = front + dfull[:, :, None] * jnp.eye(F, dtype=dt)
            if want_rhs and rhs_vert is not None:
                b = b + _piv_gather(lv, rhs_vert, 0.0, F, dt)

            L_pp, L_bp = _factor_level(front, P, B)
            dg = jnp.diagonal(L_pp, axis1=-2, axis2=-1)
            logdet = logdet + 2.0 * jnp.sum(jnp.log(dg))
            out["L_pp"][d] = L_pp
            if want_rhs:
                y = lower_solve_vec(L_pp, b[:, :P])
                out["y"][d] = y
                quad = quad + jnp.sum(y * y)
            if B > 0:
                out["L_bp"][d] = L_bp
                upd = front[:, P:, P:] - jnp.einsum("nbp,ncp->nbc", L_bp, L_bp,
                                                    precision=_PREC)
                if want_rhs:
                    bupd = b[:, P:] - jnp.einsum("nbp,np->nb", L_bp, y,
                                                 precision=_PREC)
            else:
                out["L_bp"][d] = jnp.zeros((N, 0, P), dt)
                upd = jnp.zeros((N, 0, 0), dt)
                bupd = jnp.zeros((N, 0), dt)
    out["logdet"] = logdet
    if want_rhs:
        out["quad"] = quad
    return out


def mf_forward(static, mfdev, fac, rhs_vert):
    """Forward solve L y = b for a per-vertex RHS, reusing a stored factor.

    Returns (ys, quad): per-level pivot solutions and ||y||^2.
    """
    levels = mfdev["levels"]
    D = static.depth
    dt = rhs_vert.dtype
    ys = [None] * (D + 1)
    quad = jnp.zeros((), dt)
    bupd = None
    for d in range(D, -1, -1):
        lv = levels[d]
        P = static.npiv[d]
        B = static.nbord[d]
        F = P + B
        b = _piv_gather(lv, rhs_vert, 0.0, F, dt)
        if d < D:
            b = b + _extend_add_vec(lv, F, bupd, dt)
        L_pp = fac["L_pp"][d]
        y = lower_solve_vec(L_pp, b[:, :P])
        ys[d] = y
        quad = quad + jnp.sum(y * y)
        if B > 0:
            bupd = b[:, P:] - jnp.einsum("nbp,np->nb", fac["L_bp"][d], y,
                                         precision=_PREC)
        else:
            bupd = jnp.zeros((b.shape[0], 0), dt)
    return ys, quad


def mf_backward(static, mfdev, fac, ys=None):
    """Back-substitution L^T x = y; returns x over vertices (n_vert,)."""
    levels = mfdev["levels"]
    D = static.depth
    if ys is None:
        ys = fac["y"]
    dt = ys[0].dtype
    x = jnp.zeros(static.x_size, dt)
    for d in range(D + 1):
        lv = levels[d]
        L_pp = fac["L_pp"][d]
        L_bp = fac["L_bp"][d]
        y = ys[d]
        if d > 0 and L_bp.shape[1] > 0:
            bxs = lv["bxs"]
            xb = jnp.where(bxs >= 0, x[jnp.clip(bxs, 0)], 0.0)
            rhs = y - jnp.einsum("nbp,nb->np", L_bp, xb, precision=_PREC)
        else:
            rhs = y
        xp = upper_solve_vec(L_pp, rhs)
        x = jax.lax.dynamic_update_slice(x, xp.reshape(-1),
                                         (static.x_offsets[d],))
    return x[mfdev["x_slot"]]


def mf_solve(static, mfdev, fac, rhs_vert):
    """Solve W x = rhs_vert using a stored factor; x over vertices."""
    ys, _ = mf_forward(static, mfdev, fac, rhs_vert)
    return mf_backward(static, mfdev, fac, ys)


def _sbb_from_parent(S_prev, par, bip, dt):
    """(N, B, B) parent selected-inverse block at the border positions."""
    ok = bip >= 0
    gc = jnp.clip(bip, 0)
    rows = S_prev[par[:, None], gc]               # (N, B, Fp) row gather
    rows = jnp.where(ok[:, :, None], rows, 0.0)
    ar = jnp.arange(bip.shape[0])[:, None]
    S_bb = jnp.swapaxes(rows, 1, 2)[ar, gc]       # (N, B, B)
    return jnp.where(ok[:, :, None], S_bb, 0.0)


def mf_selinv_diag(static, mfdev, fac, leaf_chunks=None):
    """diag(W^{-1}) over vertices via top-down multifrontal selected inverse.

    Block recursion (with G = L_bp L_pp^{-1}, S_bb gathered from the parent's
    selected-inverse front):
        S_bp = -S_bb G
        S_pp = L_pp^{-T} L_pp^{-1} + G^T S_bb G
    This is the multifrontal form of the Takahashi recursion the reference
    delegates to sparseinv (/root/reference/R/vecchia_prediction.R:193-197),
    and is exact here (the fronts carry the full fill pattern).

    The deepest level has no children, so only its PIVOT DIAGONAL is
    computed — in node chunks (lax.map) so its (N, F, F) selected-inverse
    fronts never materialize (they would be ~5.6 GB at n=1e6/m=40, the
    round-3 OOM); parents are streamed by an indexed gather instead of a
    materialized jnp.repeat.
    """
    levels = mfdev["levels"]
    D = static.depth
    dt = fac["L_pp"][0].dtype
    n_vert = static.n_vert
    diag_out = jnp.zeros(n_vert, dt)
    S_prev = None
    for d in range(D + 1):
        lv = levels[d]
        L_pp = fac["L_pp"][d]
        L_bp = fac["L_bp"][d]
        N, P = lv["piv_ids"].shape
        B = L_bp.shape[1]
        F = P + B
        par = jnp.arange(N) // 2
        if d == D and B > 0 and d > 0:
            # final level: diagonal only, in bounded node chunks
            if leaf_chunks is None:
                cap = memory_budget()["selinv_chunk"]
                nbytes = N * F * F * jnp.dtype(dt).itemsize
                nchunk = 1
                while nbytes // nchunk > cap and nchunk < N:
                    nchunk *= 2
            else:
                nchunk = leaf_chunks

            def leaf_diag(args):
                Lpp_c, Lbp_c, bip_c, par_c = args
                Linv = tri_inv_lower(Lpp_c)
                dgA = jnp.sum(Linv * Linv, axis=1)           # (C, P)
                S_bb = _sbb_from_parent(S_prev, par_c, bip_c, dt)
                G = jnp.einsum("nbp,npq->nbq", Lbp_c, Linv, precision=_PREC)
                t = jnp.einsum("nbc,ncq->nbq", S_bb, G, precision=_PREC)
                dgB = jnp.einsum("nbq,nbq->nq", G, t, precision=_PREC)
                return dgA + dgB

            if nchunk > 1 and N % nchunk == 0:
                C = N // nchunk
                args = (L_pp.reshape(nchunk, C, P, P),
                        L_bp.reshape(nchunk, C, B, P),
                        lv["bip"].reshape(nchunk, C, B),
                        par.reshape(nchunk, C))
                dg = jax.lax.map(leaf_diag, args).reshape(N, P)
            else:
                dg = leaf_diag((L_pp, L_bp, lv["bip"], par))
        else:
            Linv = tri_inv_lower(L_pp)
            SppA = jnp.einsum("npq,npr->nqr", Linv, Linv, precision=_PREC)
            if B > 0:
                S_bb = _sbb_from_parent(S_prev, par, lv["bip"], dt)
                G = jnp.einsum("nbp,npq->nbq", L_bp, Linv, precision=_PREC)
                S_pp = SppA + jnp.einsum("nbq,nbc,ncr->nqr", G, S_bb, G,
                                         precision=_PREC)
                S_bp = -jnp.einsum("nbc,ncq->nbq", S_bb, G, precision=_PREC)
                top = jnp.concatenate([S_pp, jnp.swapaxes(S_bp, -1, -2)],
                                      axis=-1)
                bot = jnp.concatenate([S_bp, S_bb], axis=-1)
                S_front = jnp.concatenate([top, bot], axis=-2)
            else:
                S_pp = SppA
                S_front = S_pp
            S_prev = S_front
            dg = jnp.diagonal(S_pp, axis1=-2, axis2=-1)
        piv = lv["piv_ids"]
        okp = piv >= 0
        diag_out = diag_out.at[jnp.where(okp, piv, n_vert)].set(
            jnp.where(okp, dg, 0.0), mode="drop", unique_indices=True)
    return diag_out
