"""Device-side dual-traversal interaction lists over the hybrid octree.

Port of `repro/devtree/lists.py`: the ragged-frontier form of
`interaction.build_interaction_lists`. The traversal state is a flat,
budget-padded list of (batch, cell) pairs, refined level by level. Below
the dense split depth the cells live in compacted occupied-cell blocks
(see `build.py`), so child expansion is one `searchsorted` of the eight
candidate child codes into the block's sorted code table: empty cells
are absent and drop out of the frontier. Each level classifies every
pair with the MAC of `interaction.mac_accept` (theta * R - (r_B + r_C)
> 0, the fold-free margin under `PeriodicBox`, and the (n+1)^3 < N_C
size test) in tensor ops on the device. Undecided pairs expand to their
children and are left-packed into the next level's frontier, so the work
per level is O(live pairs), each level with its own pair budget.

Everything is emitted by GATHER: left-packing an irregular candidate set
into a budgeted buffer is a `cumsum` over the mask plus one
`searchsorted` per output slot (destination j pulls the j-th set mask
bit). Nothing takes a data-dependent shape (no `nonzero`, no boolean
indexing), so no call waits for the host. The approximation lane never
sorts: every level's frontier is batch-ascending, so per-level per-batch
counts give each (batch, slot) destination its level-major rank in
closed form, and one searchsorted over the acceptance-mask cumsum turns
rank into position.

Direct coverage is emitted as PARTICLE-RANGE RUNS: the size test is
monotone (a cell with N_C <= (n+1)^3 can never be MAC-accepted, and
neither can any of its descendants), so such a cell's whole particle
range goes direct, and because leaf slots are in particle order that
range is one contiguous run of leaf slots, found with two
`searchsorted` calls against the leaf starts. Host and device give the
same direct coverage; only the order of the lanes' slots differs.

List lanes are `Capacities`-budgeted, and the internal pair buffers
(per-level frontier, direct runs, skin runs) carry budgets of their own:
overflowing entries are dropped by the compaction while the TRUE counts
come back in the needs vector, so the caller detects an overflow from
one short read and regrows.

Integer work is int32 (`out_int32` searches, int32 cumsums): the
reference's types, which a card sorts and searches faster than int64.
"""
from __future__ import annotations

import torch

from repro_torch.core.interaction import fold_drift_rate, theta_drift_rate

_I32 = torch.int32
_I32MAX = 2 ** 31 - 1


def _arange(n: int, device, start: int = 0) -> torch.Tensor:
    return torch.arange(start, start + n, dtype=_I32, device=device)


def _cumsum(m: torch.Tensor, dim: int = 0) -> torch.Tensor:
    return torch.cumsum(m.to(_I32), dim, dtype=_I32)


def _search(seq: torch.Tensor, values: torch.Tensor,
            right: bool = False) -> torch.Tensor:
    return torch.searchsorted(seq, values, out_int32=True, right=right)


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((v * v).sum(-1))


def _compact(mask_parts, val_parts, cap: int):
    """Left-pack masked values from concatenated parts into a budgeted
    buffer, by gather: slot j pulls the j-th set mask bit. Returns one
    packed tensor per (parts, fill) entry of `val_parts`."""
    m = torch.cat(mask_parts)
    c = _cumsum(m)
    want = _arange(cap, m.device, start=1)
    src = _search(c, want).clamp(0, m.shape[0] - 1)
    ok = want <= c[-1]
    return [torch.where(ok, torch.cat(parts)[src], fill)
            for parts, fill in val_parts]


def _fold(space, d, spread, like):
    """`space.fold_margin` as a tensor of `like`'s shape (free space has
    no fold: +inf)."""
    f = space.fold_margin(d, spread)
    if isinstance(f, torch.Tensor):
        return f
    return torch.full_like(like, float(f))


def lists_phase(node_lo, node_hi, node_count, node_start, node_active,
                node_leaf, node_code, leaf_start, leaf_valid, b_lo, b_hi,
                b_valid, *, depth, off, sparse, widths, pair_caps, theta,
                skin, degree, space):
    """Traverse all batches against the hybrid source octree.

    node_* are the flat (M,) / (M, 3) per-cell tensors in hybrid node-id
    order: dense level l occupies [off[l], off[l] + 8^l) through the
    split depth, then each deeper level is one compacted occupied-cell
    block described by `sparse`, a tuple of (base, rows), whose rows are
    sorted by `node_code` (cell code at the row's own level, PAD_CODE
    past the occupied count). leaf_start/leaf_valid describe the
    budgeted leaf-slot table (slots in particle-start order); b_lo/b_hi
    are exact batch bounding boxes with b_valid masking padded rows.
    `widths` = (approx, direct, skin_direct) lane budgets: zeros run a
    count-only pass (no lane-shaped tensor, the same counts). `pair_caps`
    = (per-level frontier tuple, direct runs, skin runs) traversal
    budgets.

    Returns (lists dict or None, need dict of 0-d counts, theta_slack,
    fold_slack), all on the device.
    """
    sd = depth - len(sparse)  # deepest DENSE level
    a_width, d_width, s_width = widths
    f_caps, run_cap, skin_cap = pair_caps
    npts = (degree + 1) ** 3
    has_skin = skin > 0.0
    thr_theta = theta_drift_rate(theta) * 0.5 * skin
    thr_fold = fold_drift_rate() * 0.5 * skin

    dev, dt = b_lo.device, b_lo.dtype
    nb = b_lo.shape[0]
    bc = 0.5 * (b_lo + b_hi)
    bhw = 0.5 * (b_hi - b_lo)
    rb = _norm(bhw)
    nb_edges = _arange(nb + 1, dev)
    k8 = _arange(8, dev)[None, :]

    # Per-cell classification: `testable` cells can still pass the size
    # test at or below themselves and must be MAC-evaluated; the rest go
    # direct as whole particle ranges without entering the frontier.
    testable = node_active & (node_count > npts)
    runnable = node_active & ~testable

    inf = float("inf")
    theta_slack = torch.full((), inf, dtype=dt, device=dev)
    fold_slack = torch.full((), inf, dtype=dt, device=dev)

    # Candidate parts kept per level for the deferred emissions.
    pb_parts, pg_parts, mac_parts, skin_parts = [], [], [], []
    rm_parts, rbv_parts, rgv_parts = [], [], []
    mac_cnt_parts = []
    run_total = torch.zeros((), dtype=_I32, device=dev)
    skin_total = torch.zeros((), dtype=_I32, device=dev)

    # Level-0 frontier: every valid batch against the root cell.
    c0 = _cumsum(b_valid)
    want0 = _arange(f_caps[0], dev, start=1)
    sel0 = _search(c0, want0).clamp(0, nb - 1)
    fb = torch.where(want0 <= c0[-1], sel0, nb)
    fc = torch.zeros((f_caps[0],), dtype=_I32, device=dev)
    fg = torch.zeros((f_caps[0],), dtype=_I32, device=dev)  # hybrid gid
    fneed = [c0[-1]]

    for lvl in range(depth + 1):
        valid = fb < nb
        bj = fb.clamp(0, nb - 1)
        gidx = fg  # dense: off[lvl] + fc; sparse: block base + row

        clo, chi = node_lo[gidx], node_hi[gidx]
        cc = 0.5 * (clo + chi)
        chw = 0.5 * (chi - clo)
        rc = _norm(chw)

        d = bc[bj] - cc
        dm = space.min_image(d)
        t_margin = theta * _norm(dm) - (rb[bj] + rc)
        fold = _fold(space, d, bhw[bj] + chw, t_margin)
        process = valid & node_active[gidx]
        mac = (process & (t_margin > 0.0) & (fold > 0.0)
               & (npts < node_count[gidx]))
        safe = mac & (t_margin > thr_theta) & (fold > thr_fold)
        skinp = mac & ~safe
        go_self = process & ~mac & node_leaf[gidx]
        recurse = process & ~mac & ~node_leaf[gidx]

        theta_slack = torch.minimum(
            theta_slack, torch.where(safe, t_margin, inf).amin())
        fold_slack = torch.minimum(
            fold_slack,
            torch.where(safe & torch.isfinite(fold), fold, inf).amin())

        pb_parts.append(fb)
        pg_parts.append(gidx)
        mac_parts.append(mac)
        skin_parts.append(skinp)
        # Per-batch acceptance counts: cumsum differences at the batch
        # boundaries (fb is batch-ascending with nb padding).
        cm = torch.cat([torch.zeros((1,), dtype=_I32, device=dev),
                        _cumsum(mac)])
        firsts = _search(fb, nb_edges)
        mac_cnt_parts.append(cm[firsts[1:]] - cm[firsts[:-1]])
        if has_skin:
            skin_total = skin_total + skinp.sum(dtype=_I32)

        if lvl < depth:
            kid_cell = fc[:, None] * 8 + k8
            if lvl + 1 <= sd:
                kid_gid = off[lvl + 1] + kid_cell
                kenter = recurse[:, None] & testable[kid_gid]
                krun = recurse[:, None] & runnable[kid_gid]
            else:
                # Sparse level: find each candidate child code in the
                # block's sorted code table. A missing code is an empty
                # cell; `occ` gates it out before any flag lookup can
                # alias the clipped row.
                base, r = sparse[lvl + 1 - sd - 1]
                tbl = node_code[base:base + r]
                row = _search(tbl, kid_cell)
                rc_ = row.clamp(0, r - 1)
                occ = (row < r) & (tbl[rc_] == kid_cell)
                kid_gid = base + rc_
                kenter = recurse[:, None] & occ & testable[kid_gid]
                krun = recurse[:, None] & occ & runnable[kid_gid]
            # A pair none of whose surviving children are testable
            # collapses to ONE run over the parent's whole range.
            allrun = recurse & ~kenter.any(1)
            krun = krun & ~allrun[:, None]
            prun = go_self | allrun
            rm_parts += [prun, krun.reshape(-1)]
            rbv_parts += [fb, fb[:, None].expand_as(krun).reshape(-1)]
            rgv_parts += [gidx, kid_gid.reshape(-1)]
            run_total = (run_total + prun.sum(dtype=_I32)
                         + krun.sum(dtype=_I32))

            # Next frontier by gather-compaction of the testable kids.
            km = kenter.reshape(-1)
            c = _cumsum(km)
            want = _arange(f_caps[lvl + 1], dev, start=1)
            src = _search(c, want).clamp(0, km.shape[0] - 1)
            ok = want <= c[-1]
            pair = src >> 3
            fb, fc, fg = (torch.where(ok, fb[pair], nb),
                          torch.where(ok, (fc[pair] << 3) + (src & 7), 0),
                          torch.where(ok, kid_gid.reshape(-1)[src], 0))
            fneed.append(c[-1])
        else:
            rm_parts.append(go_self)
            rbv_parts.append(fb)
            rgv_parts.append(gidx)
            run_total = run_total + go_self.sum(dtype=_I32)

    # ---- Deferred emissions ------------------------------------------
    # Approx lane, sort-free: `cnts[b, l]` counts batch b's acceptances
    # at level l. Lane slot (b, s) belongs to the level whose
    # within-batch offset covers s, and its rank in the level-major
    # candidate stream is  level_start + preceding_batches + within.
    cnts = torch.stack(mac_cnt_parts, dim=1)          # (nb, L)
    a_cnt = cnts.sum(1, dtype=_I32)
    approx_total = a_cnt.sum(dtype=_I32)
    loff = _cumsum(cnts, 1) - cnts                    # within-batch
    stot = cnts.sum(0, dtype=_I32)                    # per-level totals
    sstart = _cumsum(stot) - stot                     # level-major starts
    cbefore = _cumsum(cnts, 0) - cnts                 # earlier batches

    materialize = bool(a_width and d_width)
    if materialize:
        mall = torch.cat(mac_parts)
        call = _cumsum(mall)
        gall = torch.cat(pg_parts)
        sall = torch.cat([s.to(torch.uint8) for s in skin_parts])
        s_ar = _arange(a_width, dev)[None, :]
        a_ok = s_ar < a_cnt[:, None]
        l_of = ((loff[:, None, :] <= s_ar[:, :, None]).sum(-1, dtype=_I32)
                - 1).clamp(0, cnts.shape[1] - 1).long()
        j = s_ar - torch.gather(loff, 1, l_of)
        rank = sstart[l_of] + torch.gather(cbefore, 1, l_of) + j
        src = _search(call, rank + 1).clamp(0, mall.shape[0] - 1)
        approx_idx = torch.where(a_ok, gall[src], -1)
        approx_skin = torch.where(a_ok, sall[src], 0)

    # Run decomposition (direct and skin lanes): map each cell's particle
    # range to its contiguous leaf-slot run, then unroll runs into the
    # (batch, slot) grid; each output slot finds its source run with one
    # searchsorted against the inclusive run ends.
    key = torch.where(leaf_valid, leaf_start, _I32MAX)

    def unroll(bufs, cap, width, want_nodes):
        # lint: disable=DV002 — run-merge permutation over the O(runs)
        # compacted buffer, not the O(n) particle/key set the sort-free
        # contract covers (particle order comes from the Morton phase).
        ordp = torch.sort(bufs[0], stable=True)[1]
        pb, pg = (b[ordp] for b in bufs)
        bounds = _search(pb, nb_edges)
        ps = node_start[pg]
        plo = _search(key, ps)
        pend = _search(key, ps + node_count[pg])
        plen = torch.where(pb < nb, pend - plo, 0)
        e_excl = _cumsum(plen) - plen
        edges = torch.cat([e_excl, e_excl[-1:] + plen[-1:]])
        cnt_b = edges[bounds[1:]] - edges[bounds[:-1]]
        if not width:
            return None, None, cnt_b
        ar = _arange(width, dev)[None, :]
        g = edges[bounds[:-1, None]] + ar
        p = _search(e_excl + plen, g, right=True).clamp(0, cap - 1)
        ok = ar < cnt_b[:, None]
        slots = torch.where(ok, plo[p] + (g - e_excl[p]), -1)
        nodes = torch.where(ok, pg[p], -1) if want_nodes else None
        return slots, nodes, cnt_b

    rn = _compact(rm_parts, [(rbv_parts, nb), (rgv_parts, 0)], run_cap)
    direct_idx, _, d_cnt = unroll(rn, run_cap,
                                  d_width if materialize else 0, False)
    if has_skin:
        sp = _compact(skin_parts, [(pb_parts, nb), (pg_parts, 0)],
                      skin_cap)
        skin_direct, skin_direct_node, s_cnt = unroll(
            sp, skin_cap, s_width if materialize else 0, True)
    else:
        s_cnt = torch.zeros((nb,), dtype=_I32, device=dev)
        skin_direct = torch.full((nb, s_width), -1, dtype=_I32, device=dev)
        skin_direct_node = skin_direct.clone()

    need = dict(
        approx_width=a_cnt.amax(),
        direct_width=d_cnt.amax(),
        skin_direct_width=s_cnt.amax(),
        approx_total=approx_total,
        direct_total=d_cnt.sum(dtype=_I32),
        frontier_pairs=tuple(fneed),
        run_pairs=run_total,
        skin_pairs=skin_total,
    )

    lists = None
    if materialize:
        lists = dict(
            approx_idx=approx_idx,
            approx_skin=approx_skin,
            direct_idx=direct_idx,
            skin_direct=skin_direct,
            skin_direct_node=skin_direct_node,
        )
    return lists, need, theta_slack, fold_slack
