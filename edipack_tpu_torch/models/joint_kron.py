"""Blocked-Kronecker joint-sector operator for superc / nonsu2, in
complex128 (counterpart of edipack_tpu.models.joint_kron).

Every joint Sz / Ntot sector decomposes into (Nup, Ndw) product blocks;
within a block the basis is ups x dws exactly as in the normal mode, so

* every particle-number-conserving same-spin term (Hloc hopping,
  hybridization, bath hops — most of the nonzeros) is a per-block
  Kronecker factor: dense (dup x dup) / (ddw x ddw) matmuls;
* pairing terms (superc: c†↑c†↓, Δ-bath) and spin-flip terms (nonsu2: SOC,
  in-plane fields, u-hybridization) connect neighbouring blocks as per-spin
  signed partial permutations, with the cross-register Jordan-Wigner string
  reduced to the per-block scalar (-1)^{Nup};
* mixed four-operator strings (Jx/Jp, nonsu2 sundry) split per register the
  same way.

The operator's vector layout is the concatenation of per-block
(dim_ph, ddw, dup) tensors ("blocked layout"); ``to_internal_flat`` /
``from_internal_flat`` convert to and from the sorted joint basis by one
fixed permutation, the contract the Lanczos and GF code already uses for
internal-layout operators. Under a mesh of ranks (parallel.mesh),
:class:`ShardedJointKronMatvec` splits every block's dw rows over them.
The cross-block terms of one (source, target) block pair are applied
together (or in groups of at most ``gather_chunk`` terms): one stacked
two-axis gather and one weighted reduction a group
(:meth:`JointKronMatvec._gather_take`, :meth:`_gather_reduce`).

Parity target: the dense matrix of this operator under the sorted
permutation equals models/joint.build_joint_sector_op().to_dense().
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import EDConfig
from ..fock import apply_c, apply_cdg, enumerate_states, occupations, \
    state_index
from ..sectors import Sector

CDTYPE = torch.complex128


@dataclass
class _Block:
    nup: int
    ndw: int
    ups: np.ndarray       # sorted up-register basis (C(ns,nup) ints)
    dws: np.ndarray       # sorted dw-register basis
    offset: int           # start of this block in the blocked flat layout

    @property
    def dup(self) -> int:
        return len(self.ups)

    @property
    def ddw(self) -> int:
        return len(self.dws)

    @property
    def size(self) -> int:
        return self.dup * self.ddw


@dataclass
class _GatherTerm:
    """out[dst] += coeff * (dw_sgn ⊙ v[src][dw_src][:, up_src] ⊙ up_sgn)."""
    src: int
    dst: int
    coeff: complex
    up_src: np.ndarray    # (dup_dst,) int32 source column per target column
    up_sgn: np.ndarray    # (dup_dst,) float (0 invalidates)
    dw_src: np.ndarray    # (ddw_dst,) int32
    dw_sgn: np.ndarray


def _register_map(basis_src: np.ndarray, basis_dst: np.ndarray,
                  ops: List[Tuple[str, int]]):
    """Compose a single-register operator substring; returns target-indexed
    (src_idx, sign) arrays over basis_dst (0/0 where no source)."""
    st = np.asarray(basis_src, np.int64)
    sign = np.ones(len(st))
    valid = np.ones(len(st), dtype=bool)
    for kind, lvl in ops:
        fn = apply_c if kind == "c" else apply_cdg
        st, s, v = fn(st, lvl)
        sign = sign * s
        valid &= v
    tgt = state_index(np.asarray(basis_dst, np.int64), st[valid])
    srcs = np.nonzero(valid)[0]
    good = tgt >= 0
    src_of = np.zeros(len(basis_dst), np.int32)
    sgn_of = np.zeros(len(basis_dst))
    src_of[tgt[good]] = srcs[good]
    sgn_of[tgt[good]] = sign[valid][good]
    return src_of, sgn_of


class BlockedTermAccumulator:
    """JointTermAccumulator-compatible accumulator that builds the
    blocked-Kron structure instead of sorted COO. Basis order: the blocks
    in (Nup, Ndw) scan order; within a block, index = idw * dup + iup (up
    fastest)."""

    def __init__(self, sec: Sector, ns: int):
        self.ns = ns
        pairs = []
        if sec.mode == "superc":
            sz = sec.qn[1]
            for nup in range(max(0, sz), min(ns, ns + sz) + 1):
                ndw = nup - sz
                if 0 <= ndw <= ns:
                    pairs.append((nup, ndw))
        else:  # nonsu2 (nt)
            n = sec.qn[1]
            for nup in range(max(0, n - ns), min(ns, n) + 1):
                pairs.append((nup, n - nup))
        blocks: List[_Block] = []
        off = 0
        for nup, ndw in pairs:
            b = _Block(nup, ndw, enumerate_states(ns, nup),
                       enumerate_states(ns, ndw), off)
            blocks.append(b)
            off += b.size
        self.blocks = blocks
        self.dim = off
        self._bidx: Dict[Tuple[int, int], int] = {
            (b.nup, b.ndw): i for i, b in enumerate(blocks)}
        # blocked-order joint states (for occ/diag and the sorted perm)
        parts = [(b.ups[None, :] | (b.dws[:, None] << np.int64(ns))).ravel()
                 for b in blocks]
        self.states = (np.concatenate(parts) if parts
                       else np.zeros(0, np.int64))
        self.occ = occupations(self.states, 2 * ns).astype(np.float64)
        self.diag = np.zeros(self.dim)
        self.eph_diag = None
        self.hup = [np.zeros((b.dup, b.dup), complex) for b in blocks]
        self.hdw = [np.zeros((b.ddw, b.ddw), complex) for b in blocks]
        self.gathers: List[_GatherTerm] = []

    # -- JointTermAccumulator interface ---------------------------------
    def pos(self, level: int, spin: int) -> int:
        return level + spin * self.ns

    def add_diag(self, d: np.ndarray) -> None:
        self.diag += np.real(d)

    def add_opstring(self, ops: List[Tuple[str, int, int]],
                     coeff: complex) -> None:
        if coeff == 0:
            return
        # split per register, tracking the cross-register JW bookkeeping:
        # a dw operator's global string covers all up bits, i.e. a factor
        # (-1)^{nup at application time} = (-1)^{nup_block + dnup_so_far}
        up_ops: List[Tuple[str, int]] = []
        dw_ops: List[Tuple[str, int]] = []
        dnup = 0
        cross_fixed = 0          # sum of dnup values at each dw op
        for kind, lvl, spin in ops:
            if spin == 0:
                up_ops.append((kind, lvl))
                dnup += 1 if kind == "cdg" else -1
            else:
                dw_ops.append((kind, lvl))
                cross_fixed += dnup
        ddw_n = sum(1 if k == "cdg" else -1 for k, _ in dw_ops)
        n_dw_ops = len(dw_ops)

        for i, b in enumerate(self.blocks):
            j = self._bidx.get((b.nup + dnup, b.ndw + ddw_n))
            if j is None:
                continue
            tgt = self.blocks[j]
            up_src, up_sgn = _register_map(b.ups, tgt.ups, up_ops)
            dw_src, dw_sgn = _register_map(b.dws, tgt.dws, dw_ops)
            if not up_sgn.any() or not dw_sgn.any():
                continue
            c = coeff * (-1.0) ** ((n_dw_ops * b.nup + cross_fixed) % 2)
            # same-spin within-block single-register maps merge into the
            # dense Kron factors
            if not dw_ops and i == j:
                nz = up_sgn != 0
                self.hup[i][np.nonzero(nz)[0], up_src[nz]] += c * up_sgn[nz]
                continue
            if not up_ops and i == j:
                nz = dw_sgn != 0
                self.hdw[i][np.nonzero(nz)[0], dw_src[nz]] += c * dw_sgn[nz]
                continue
            self.gathers.append(_GatherTerm(
                src=i, dst=j, coeff=c,
                up_src=up_src.astype(np.int32), up_sgn=up_sgn,
                dw_src=dw_src.astype(np.int32), dw_sgn=dw_sgn))


class JointKronMatvec:
    """Matvec over the blocked layout, in complex128 on ``device``.

    ``__call__(v)`` takes and returns the flat blocked vector
    (dim_ph * dim_el), or a (B, dim_ph * dim_el) block of B of them
    (``batched``: the GF chains of one target sector run through it
    together); to_internal_flat / from_internal_flat convert one vector at
    the sorted-basis boundary."""

    batched = True

    def __init__(self, cfg: EDConfig, sec: Sector,
                 acc: BlockedTermAccumulator,
                 eph_acc: Optional[BlockedTermAccumulator],
                 device: torch.device, gather_chunk: int = 0):
        from .normal import _phonon_matrices
        self.sector = sec
        self.blocks = acc.blocks
        self.dim_el = acc.dim
        self.dim_ph = sec.dim_ph
        self.dim = self.dim_el * self.dim_ph
        self.dtype = CDTYPE
        self.device = device
        self.n_calls = 0
        self._graphs = {}       # input shape -> CUDA graph of _body() and
        #                         its static input and output (_run)
        self._pool = None       # the one memory pool of those graphs
        self._row_parts = {}    # output rows -> the operands cut to them
        # terms of one (source, target) block pair gathered together, at
        # most (0: all of them). edipack_tpu takes 6 on the TPU; on the H100
        # one group a pair is 1.26-1.29x faster at the 2.7M-state sectors
        # (chip_smoke.py's joint phase measures both; PERF.md)
        self.gather_chunk = gather_chunk

        def put(x, dtype=CDTYPE):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

        def factors(a: BlockedTermAccumulator):
            """Per-block diagonal and dense spin factors (None if zero)."""
            diag = [put(a.diag[b.offset:b.offset + b.size]
                        .reshape(b.ddw, b.dup), torch.float64)
                    for b in self.blocks]
            hup_t = [put(h.T) if np.any(h) else None for h in a.hup]
            hdw = [put(h) if np.any(h) else None for h in a.hdw]
            return diag, hup_t, hdw, self._group_gathers(a.gathers, put)

        self.el = factors(acc)
        self.has_ph = cfg.nph > 0
        self.eph = None
        if self.has_ph:
            ph_mat, ph_x = _phonon_matrices(cfg)
            self.ph_mat = put(np.real(ph_mat))
            self.ph_x = put(np.real(ph_x))
            eph_acc.diag = acc.eph_diag
            self.eph = factors(eph_acc)

        # sorted -> blocked position map: sorted index k lives at blocked
        # position scatter_idx[k]
        order = np.argsort(acc.states, kind="stable")
        self._scatter_idx = torch.as_tensor(order, device=device)
        self._offsets = [b.offset for b in self.blocks]
        nnz = int(np.sum(np.abs(acc.diag) > 0))
        for b, h in zip(self.blocks, acc.hup):
            nnz += int(np.count_nonzero(h)) * b.ddw
        for b, h in zip(self.blocks, acc.hdw):
            nnz += int(np.count_nonzero(h)) * b.dup
        nnz += sum(int(np.count_nonzero(g.up_sgn))
                   * int(np.count_nonzero(g.dw_sgn)) for g in acc.gathers)
        self.nnz = max(nnz, acc.dim) * max(1, self.dim_ph)

    def _group_gathers(self, gs: List[_GatherTerm], put):
        """Stack the gather terms of one (src, dst) block pair, in chunks of
        at most ``gather_chunk`` terms (0: all of them), into factorized
        tables: dw_idx (k, ddw)
        and up_idx (k, dup) sources, the complex weight wdw[k, d] = coeff_k
        * dw_sgn_k[d] and the exact sign usgn[k, u]."""
        groups: Dict[Tuple[int, int], list] = {}
        for g in gs:
            groups.setdefault((g.src, g.dst), []).append(g)
        out = []
        for (src, dst), lst in sorted(groups.items()):
            size = self.gather_chunk or len(lst)
            nch = max(1, -(-len(lst) // size))
            bounds = np.linspace(0, len(lst), nch + 1).astype(int)
            for lo, hi in zip(bounds[:-1], bounds[1:]):
                part = lst[lo:hi]
                dw_idx = np.stack([g.dw_src for g in part]).astype(np.int64)
                up_idx = np.stack([g.up_src for g in part]).astype(np.int64)
                wdw = np.stack([g.coeff * g.dw_sgn for g in part])
                usgn = np.stack([g.up_sgn for g in part])
                out.append((src, dst, put(dw_idx, torch.int64),
                            put(up_idx, torch.int64), put(wdw),
                            put(usgn, torch.float64)))
        return out

    # -- layout conversion ----------------------------------------------
    def to_internal_flat(self, v_sorted: torch.Tensor) -> torch.Tensor:
        """sorted-basis vector -> blocked layout (scatter)."""
        v2 = v_sorted.reshape(self.dim_ph, self.dim_el).to(self.dtype)
        out = torch.empty_like(v2)
        out[:, self._scatter_idx] = v2
        return out.reshape(-1)

    def from_internal_flat(self, v_blocked: torch.Tensor) -> torch.Tensor:
        v2 = v_blocked.reshape(self.dim_ph, self.dim_el)
        return v2.index_select(1, self._scatter_idx).reshape(-1)

    # -- matvec ----------------------------------------------------------
    @staticmethod
    def _gather_take(v: torch.Tensor, dw_idx: torch.Tensor,
                     up_idx: torch.Tensor) -> torch.Tensor:
        """t2[p,k,d,u] = v[p, dw_idx[k,d], up_idx[k,u]] for one group: an
        index_select along dw, then a gather along up."""
        dp, _, dup_s = v.shape
        k, ddw = dw_idx.shape
        dup = up_idx.shape[1]
        t = v.index_select(1, dw_idx.reshape(-1)).view(dp, k, ddw, dup_s)
        return torch.gather(t, 3, up_idx.view(1, k, 1, dup).expand(
            dp, k, ddw, dup))

    @staticmethod
    def _gather_reduce(t2: torch.Tensor, wdw: torch.Tensor,
                       usgn: torch.Tensor) -> torch.Tensor:
        """out[p,d,u] = Σ_k wdw[k,d] * usgn[k,u] * t2[p,k,d,u]."""
        t2 = t2 * usgn[None, :, None, :]
        return (t2 * wdw[None, :, :, None]).sum(1)

    def _apply_el(self, vb: List[torch.Tensor], parts,
                  rows=None) -> List[torch.Tensor]:
        """One electronic application on the per-block tensor list; with
        ``rows`` ((lo, hi) per block), each block's output rows [lo, hi)
        only, from ``parts`` restricted to them (:meth:`_sliced`)."""
        diag, hup_t, hdw, gathers = parts
        out = []
        for i, v in enumerate(vb):
            vr = v if rows is None else v[:, rows[i][0]:rows[i][1]]
            w = diag[i] * vr
            if hup_t[i] is not None:
                w += vr @ hup_t[i]
            if hdw[i] is not None:
                w += torch.matmul(hdw[i], v)
            out.append(w)
        for (src, dst, dw_idx, up_idx, wdw, usgn) in gathers:
            out[dst] += self._gather_reduce(
                self._gather_take(vb[src], dw_idx, up_idx), wdw, usgn)
        return out

    def _sliced(self, rows):
        """The operands of :meth:`apply` restricted to the output rows
        ``rows`` ((lo, hi) per block): the diagonal's and hdw's rows, each
        gather group's dw_idx and wdw columns of its target block;
        contiguous copies, made once for each ``rows`` and kept on the
        device."""
        key = tuple(rows)
        if key not in self._row_parts:
            sl = [slice(lo, hi) for lo, hi in rows]

            def cut(parts):
                diag, hup_t, hdw, gathers = parts
                return ([d[s].contiguous() for d, s in zip(diag, sl)], hup_t,
                        [None if h is None else h[s].contiguous()
                         for h, s in zip(hdw, sl)],
                        [(src, dst, dw_idx[:, sl[dst]].contiguous(), up_idx,
                          wdw[:, sl[dst]].contiguous(), usgn)
                         for src, dst, dw_idx, up_idx, wdw, usgn in gathers])
            self._row_parts[key] = (
                cut(self.el), None if self.eph is None else cut(self.eph))
        return self._row_parts[key]

    def split_blocks(self, v: torch.Tensor) -> List[torch.Tensor]:
        """Per-block (rows, ddw, dup) views; the rows are the phonon axis,
        with a leading batch axis folded into it."""
        v2 = v.reshape(-1, self.dim_el)
        return [v2[:, b.offset:b.offset + b.size]
                .reshape(-1, b.ddw, b.dup) for b in self.blocks]

    def join_blocks(self, vb: List[torch.Tensor]) -> torch.Tensor:
        return torch.cat([w.flatten(1) for w in vb], dim=1)

    def apply(self, v: torch.Tensor, rows=None) -> torch.Tensor:
        """H·v on the blocked layout, ``v`` (..., dim): a few small
        kernels a block and a gather group. ``rows`` ((lo, hi) per block):
        only those dw rows of each block's output, from the whole ``v``;
        the result is then laid out as (..., dim_ph, Σ_b (hi_b - lo_b) ·
        dup_b), the blocks' rows in block order in each phonon plane."""
        lead = v.shape[:-1]
        vb = self.split_blocks(v.to(self.dtype))
        el, eph = (self.el, self.eph) if rows is None \
            else self._sliced(rows)
        out = self._apply_el(vb, el, rows)
        if self.has_ph:
            # phonon oscillator + e-ph: X ⊗ (eph_diag + eph hops), over the
            # phonon axis of each vector of the batch
            ev = self._apply_el(vb, eph, rows)
            for i in range(len(out)):
                vi = vb[i] if rows is None else vb[i][:, slice(*rows[i])]
                vi = vi.reshape(vi.shape[0] // self.dim_ph, self.dim_ph,
                                *vi.shape[1:])
                ei = ev[i].reshape(vi.shape)
                out[i] += torch.einsum("pq,bqdu->bpdu", self.ph_mat,
                                       vi).reshape(out[i].shape)
                out[i] += torch.einsum("pq,bqdu->bpdu", self.ph_x,
                                       ei).reshape(out[i].shape)
        w = self.join_blocks(out)
        return w.reshape(*lead, self.dim_ph * w.shape[1])

    def _body(self, x: torch.Tensor) -> torch.Tensor:
        """What a call computes from the input it replays (apply)."""
        return self.apply(x)

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        self.n_calls += 1
        return self._run(v)

    def _run(self, v: torch.Tensor) -> torch.Tensor:
        """:meth:`_body` of ``v``: eager on the CPU; on the card the replay
        of its CUDA graph for ``v``'s shape."""
        if v.device.type != "cuda":
            return self._body(v)
        # on the card the launches of apply(), not its work, set the time of
        # a small sector's matvec (config 3's blocked-Kron solve took 3x the
        # ELL's): they are captured once for each input shape (one vector,
        # or a block of B) as a CUDA graph on a static input buffer and
        # replayed. The graphs share one memory pool: each holds only its
        # static input and output, and its temporaries are the others'
        # (the replays run one after the other on one stream)
        shape = tuple(v.shape)
        if shape not in self._graphs:
            self._graphs[shape] = self._capture(v)
        graph, x, y = self._graphs[shape]
        x.copy_(v)
        graph.replay()
        return y.clone()

    def _capture(self, v: torch.Tensor):
        x = v.to(self.dtype).clone()
        stream = torch.cuda.current_stream(v.device)
        side = torch.cuda.Stream(v.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            self._body(x)                # warm-up, outside the capture
        stream.wait_stream(side)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool):
            y = self._body(x)
        return graph, x, y

    def to_dense(self) -> np.ndarray:
        """Dense matrix in the blocked layout (tests)."""
        eye = torch.eye(self.dim, dtype=self.dtype, device=self.device)
        return torch.stack([self(eye[:, i]) for i in range(self.dim)],
                           dim=1).cpu().numpy()


class ShardedJointKronMatvec(JointKronMatvec):
    """:class:`JointKronMatvec` with every block's dw rows split over the
    ranks of ``mesh`` (edipack_tpu's JointKronMatvec under a mesh, which
    pads each block's dw axis to a mesh multiple and row-shards it): this
    rank owns rows ``mesh.rows(ddw_b)`` of each block, uneven blocks
    unpadded. A call gathers v whole, one collective whatever the number
    of blocks (:meth:`gather`), and computes this rank's rows of H·v
    (:meth:`JointKronMatvec.apply` with ``rows``); on the card the gather
    runs outside the CUDA graph, which replays that body from its static
    input. Takes and returns this rank's rows: in each phonon plane the
    blocks' rows in block order, (ph, Σ_b rows_b · dup_b), flat or a
    (B, local dim) block."""

    def __init__(self, cfg: EDConfig, sec: Sector,
                 acc: BlockedTermAccumulator,
                 eph_acc: Optional[BlockedTermAccumulator],
                 device: torch.device, mesh, gather_chunk: int = 0):
        super().__init__(cfg, sec, acc, eph_acc, device, gather_chunk)
        self.mesh = mesh
        self.rows = [mesh.rows(b.ddw) for b in self.blocks]
        self._sliced(self.rows)
        # the electronic positions each rank owns, in its local order
        owned = []
        for r in range(mesh.world):
            parts = []
            for b in self.blocks:
                lo, hi = mesh.rows(b.ddw, r)
                parts.append(b.offset + np.arange(lo * b.dup, hi * b.dup))
            owned.append(np.concatenate(parts))
        self.local_el = len(owned[mesh.rank])
        self.local_dim = self.local_el * self.dim_ph
        self._width = max(len(o) for o in owned)
        # whole position -> its place among the ranks' padded pieces
        where = np.empty(self.dim_el, np.int64)
        for r, o in enumerate(owned):
            where[o] = r * self._width + np.arange(len(o))
        self._local_idx = torch.as_tensor(owned[mesh.rank], device=device)
        self._unpack = torch.as_tensor(where, device=device)

    def local(self, v: torch.Tensor) -> torch.Tensor:
        lead = v.shape[:-1]
        return v.reshape(*lead, self.dim_ph, self.dim_el).index_select(
            -1, self._local_idx).reshape(*lead, self.local_dim)

    def gather(self, v: torch.Tensor) -> torch.Tensor:
        """The whole blocked vector (or block) from every rank's rows: each
        rank's rows padded to the longest rank's, one all-gather, one
        index_select into place."""
        lead = v.shape[:-1]
        x = v.reshape(-1, self.local_el)
        if self.local_el < self._width:
            x = torch.cat([x, x.new_zeros(x.shape[0],
                                          self._width - self.local_el)], 1)
        world = self.mesh.world
        full = self.mesh.all_gather_rows(x.reshape(-1), world * x.numel(), 0)
        full = full.view(world, -1, self._width).transpose(0, 1)
        return full.reshape(-1, world * self._width).index_select(
            1, self._unpack).reshape(*lead, self.dim)

    def _body(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(x, self.rows)

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        self.n_calls += 1
        return self._run(self.gather(v))


def build_joint_kron_op(cfg: EDConfig, sec: Sector, hloc, um, bath,
                        device: torch.device, hloc_anomalous=None,
                        mesh=None) -> JointKronMatvec:
    """The sector's blocked-Kron operator; with ``mesh``
    (parallel.mesh.Mesh), split over its ranks
    (:class:`ShardedJointKronMatvec`)."""
    from .joint import _enumerate_joint_terms
    if sec.qn[0] not in ("sz", "nt"):
        raise ValueError("blocked-Kron operator requires full (Nup,Ndw) "
                         "product blocks; Jz-filtered sectors use the ELL "
                         "path")
    acc = BlockedTermAccumulator(sec, sec.ns)
    eph = _enumerate_joint_terms(cfg, sec, hloc, um, bath, hloc_anomalous,
                                 acc, lambda: BlockedTermAccumulator(
                                     sec, sec.ns))
    if mesh is not None:
        return ShardedJointKronMatvec(cfg, sec, acc, eph, device, mesh)
    return JointKronMatvec(cfg, sec, acc, eph, device)
