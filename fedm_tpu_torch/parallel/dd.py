"""DOF-partitioned domain decomposition with halo exchange (the JAX
package's `parallel/dd.py`): N parts stacked on one device, or spread
over the ranks of a process group, one rank per card.

Layout
------
Cells are partitioned by the native greedy graph-growing partitioner
(`native.partition_graph`, the SCOTCH role in DOLFIN) on the dual graph.
Each dof is owned by one part, the least part index over the cells that
hold it. Part-local dof numbering:

  [0, n_own_max)                     owned dofs (padded with phantoms)
  [n_own_max, n_own_max+n_ghost_max) ghost dofs (sorted by global id)
  n_ext-1                            trash row (padded elements gather
                                     0 here, and have no scatter slot)

The distributed state is ``u_dist[N*n_own_max, n_eq]``: row
``p*n_own_max + s`` is owned slot ``s`` of part ``p``, exactly the JAX
package's layout. Phantom rows behave like Dirichlet rows with value 0, so
every solver path keeps them exactly zero.

A process holds its parts stacked along a leading axis, where the JAX
package runs one `shard_map` over a device mesh. The extended arrays are
``[L, n_ext, ...]``, flattened to ``[L*n_ext, ...]`` for the kernels, and
the per-part element arrays are stacked ``[L*c_max, ...]`` with local
part j's dofs offset by ``j*n_ext``: one element-kernel call and one K1
launch serve all L parts. Without a group L = N, every part on one
device. With a group of R ranks (`parallel.ranks`: one process per card,
NCCL on CUDA, gloo on the CPU) rank r holds parts ``[r*L, (r+1)*L)``,
L = N/R, and its rows ``[r*L*n_own_max, (r+1)*L*n_own_max)`` of the
state; every rank builds the host tables of all N parts (the partitioner
is deterministic, and the ranks check it) and keeps its own on its card.

Halo exchange
-------------
For each distinct ring shift ``d`` (owner part -> needing part distance)
the tables send/recv/mask ``[N, S]`` are aligned lane for lane on sender
and receiver by sorting the shared dofs by global id. The JAX package's
`ppermute` with perm ``(i, (i + d) % N)`` is, on a ``[N, S, ...]``
payload, ``torch.roll(payload, d, 0)``; the reverse exchange rolls by
``-d``:

  forward  (fill ghosts):   payload = own[send];  roll(+d);
                            ghosts[recv] = payload
  reverse  (reduce adds):   payload = ghost_contrib[recv] * mask;
                            roll(-d);  own[send] += payload

Over ranks, a payload row whose receiving part lies on the same rank is
moved as by the roll; the rows for another rank's parts go to that rank
alone, point to point (`Group.exchange`), and nothing else of the state
crosses ranks. The receiver writes them where the roll would have, and
the reverse exchange accumulates in the same order, so the residual and
the node blocks are those of the stacked run bit for bit.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from ..mesh.reorder import cell_adjacency_csr
from ..model.system import CoupledSystem, StepOperators, StepParams
from ..native import partition_graph
from ..solvers.newton import newton_krylov
from ..solvers.precond import block_apply, invert_blocks


def _mode_rows(a: np.ndarray, n_parts: int) -> np.ndarray:
    """Row-wise mode of small integer arrays (facet part = majority owner
    of its dofs)."""
    cnt = np.zeros((a.shape[0], n_parts), np.int32)
    rows = np.arange(a.shape[0])
    for j in range(a.shape[1]):
        cnt[rows, a[:, j]] += 1
    return cnt.argmax(axis=1).astype(np.int32)


def _resolve(devices: Sequence) -> List[torch.device]:
    devs = [torch.device(d) for d in devices]
    return [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devs]


def _one_device(devices: Sequence) -> torch.device:
    """The device every part lies on; distinct devices raise: one process
    drives one device, and parts (or members) on distinct cards need one
    rank per card."""
    devs = _resolve(devices)
    if not devs:
        raise ValueError("distribute needs at least one device")
    if len(set(devs)) > 1:
        raise NotImplementedError(
            f"parts on distinct devices ({sorted(map(str, set(devs)))}) "
            "need one process per card: start the ranks with "
            "fedm_tpu_torch.parallel.ranks.launch (or torchrun) and pass "
            "each rank's group; in one process, pass the same device N "
            "times")
    return devs[0]


def rank_device(devices: Sequence, group) -> torch.device:
    """The device of this rank's block of `devices` (rank r takes entries
    [r*L, (r+1)*L), L = len(devices) / group.size): each must be the
    group's device."""
    n, R = len(devices), group.size
    if n == 0 or n % R:
        raise ValueError(f"{n} parts or members do not split evenly over "
                         f"{R} ranks")
    L = n // R
    mine = set(_resolve(devices[group.rank * L:(group.rank + 1) * L]))
    if mine != {group.device}:
        raise ValueError(f"rank {group.rank} runs on {group.device}; its "
                         f"entries of the device list are "
                         f"{sorted(map(str, mine))}")
    return group.device


class DistOperators(StepOperators):
    """`StepOperators` of a `DistributedSystem`: the batches gather from
    the halo-filled stacked extended layout and scatter into it, and the
    halo reduction returns the sums to the owners. Every tensor is
    [N*n_own_max, ...] at the boundary, as the state."""

    def __init__(self, dsys: "DistributedSystem", u_old, u_old1,
                 params: StepParams, dtype, aux=None):
        self.dsys = dsys
        self.n_dofs = dsys.n_local * dsys.n_ext  # rows the scatters write
        self.n_eq = dsys.n_eq
        self.dtype = dtype
        self.mask = dsys.mask_dist
        self._setup([(b.astype(dtype), k) for b, k in dsys._batches],
                    dsys._values_dist(params.t), u_old, u_old1, params, aux)

    def _in(self, x):
        return self.dsys._halo_fill(x)

    def _out(self, r):
        return self.dsys._halo_reduce(r)


class DistributedSystem:
    """Drop-in for `CoupledSystem` with the DOF-partitioned layout.

    The same `step(u_guess, u_old, u_old1, aux, params)` contract, but
    every `[n_dofs, ...]` array (state, aux fields) lives in the
    distributed layout: convert with `to_dist` / `from_dist`. `step`
    always runs `newton_krylov`, as the JAX package's does; the driver's
    predictor gate reads `newton.host_loop`, and there is no
    `row_scaled`.

    `devices`: the part-to-device list, one entry per part. Without a
    `group` every entry is the one device the system lives on. With a
    group (`parallel.ranks.Group`) rank r holds parts [r*L, (r+1)*L) and
    their entries must be its card; the state, the aux fields and every
    vector of the solvers are then this rank's rows of the distributed
    layout, and every reduction is over the group. `from_dist` and
    `gather_global` are collectives there: every rank calls them.
    """

    def __init__(self, system: CoupledSystem, devices: Sequence,
                 group=None):
        self.inner = system
        self.group = group
        N = len(devices)
        if group is None:
            self.device = _one_device(devices)
            R, rank = 1, 0
        else:
            self.device = rank_device(devices, group)
            R, rank = group.size, group.rank
        if self.device != system.bcs.mask.device:
            raise ValueError(f"the system lives on {system.bcs.mask.device}"
                             f"; distribute it over that device, not "
                             f"{self.device}")
        self.n_eq = system.n_eq
        self.newton = system.newton
        self.n_parts = N
        L = N // R
        self.n_local, self.part0 = L, rank * L   # this rank's parts
        self.n_ranks, self.rank = R, rank
        n_dofs = system.n_dofs
        batches = list(system._batches())

        # -- cell partition + dof ownership (host, once) ---------------------
        mesh = system.cell_batch.space.mesh
        cell_part = partition_graph(*cell_adjacency_csr(mesh), N)
        self.cell_part = cell_part
        if group is not None:
            group.check_same(part_checksum(cell_part),
                             "the native partition")

        cb_dofs = system.cell_batch.dofs_np
        owner = np.full(n_dofs, N, np.int32)
        np.minimum.at(owner, cb_dofs.reshape(-1),
                      np.repeat(cell_part, cb_dofs.shape[1]).astype(np.int32))
        owner[owner == N] = 0  # dofs in no cell (cannot happen for P1/P2)

        counts = np.bincount(owner, minlength=N)
        n_own_max = int(counts.max())
        order = np.argsort(owner, kind="stable")
        starts = np.concatenate([[0], np.cumsum(counts)])
        slot = np.empty(n_dofs, np.int64)
        slot[order] = np.arange(n_dofs) - starts[owner[order]]

        self.n_own_max = n_own_max
        self.n_dofs_dist = N * n_own_max
        self.n_rows = L * n_own_max   # this rank's rows of the layout
        self.row0 = self.part0 * n_own_max
        slot_of = owner.astype(np.int64) * n_own_max + slot
        dist_src = np.full(self.n_dofs_dist, n_dofs, np.int64)
        dist_src[slot_of] = np.arange(n_dofs)
        self._slot_of = slot_of          # global dof -> dist row
        self._dist_src = dist_src        # dist row -> global dof (n_dofs=phantom)

        # -- element parts and per-part ghost sets ---------------------------
        el_parts = []
        for batch, _ in batches:
            if batch is system.cell_batch:
                el_parts.append(np.asarray(cell_part, np.int32))
            else:
                el_parts.append(_mode_rows(owner[batch.dofs_np], N))

        ghost: List[np.ndarray] = []
        for p in range(N):
            refs = [b.dofs_np[pe == p].ravel()
                    for (b, _), pe in zip(batches, el_parts)]
            refs = (np.unique(np.concatenate(refs)) if any(len(r) for r in refs)
                    else np.zeros(0, np.int64))
            ghost.append(refs[owner[refs] != p].astype(np.int64))
        self.n_ghost_max = int(max((len(g) for g in ghost), default=0))
        self.n_ext = n_own_max + self.n_ghost_max + 1  # + trash row
        trash = self.n_ext - 1

        # -- per-part element batches, stacked (reordered by part, padded):
        # this rank's parts, part p's dofs offset by (p - part0) * n_ext
        p0 = self.part0
        self._batches = []      # (stacked batch, kernel)
        for (batch, kernel), pe in zip(batches, el_parts):
            c = np.bincount(pe, minlength=N)
            c_max = max(int(c.max()), 1)
            src = np.full(N * c_max, -1, np.int64)
            ord_el = np.argsort(pe, kind="stable")
            st = np.concatenate([[0], np.cumsum(c)])
            pos = np.arange(len(pe)) - st[pe[ord_el]]
            src[pe[ord_el].astype(np.int64) * c_max + pos] = ord_el
            src = src[p0 * c_max:(p0 + L) * c_max]
            pad = src < 0
            src_c = np.where(pad, 0, src)
            row_part = np.repeat(np.arange(p0, p0 + L), c_max)

            arrays = {}
            for f in batch._SHARD_FIELDS:
                a = (batch.dofs_np if f == "dofs" else
                     getattr(batch, f).cpu().numpy())[src_c]
                if f == "scale":
                    a = np.where(pad[:, None], 0.0, a)
                elif f == "dofs":
                    gpos = np.empty(a.shape, np.int64)
                    for p in range(p0, p0 + L):
                        rows = row_part == p
                        gpos[rows] = np.searchsorted(ghost[p], a[rows])
                    local = np.where(owner[a] == row_part[:, None],
                                     slot[a], n_own_max + gpos)
                    a = np.where(pad[:, None], trash, local).astype(np.int32)
                    # the stacked numbering: local part j's rows from
                    # j*n_ext
                    a = a + ((row_part - p0) * self.n_ext)[:, None].astype(
                        np.int32)
                arrays[f] = a
            # padded elements scatter into the trash rows, which nothing
            # reads: they get no slot (a facet batch pads most parts)
            self._batches.append(
                (batch.local_view(arrays, L * self.n_ext, dead=pad), kernel))

        # -- halo-exchange tables ---------------------------------------------
        shared: Dict[tuple, np.ndarray] = {}
        for dst in range(N):
            g = ghost[dst]
            o = owner[g]
            for sp in np.unique(o):
                shared[(int(sp), dst)] = g[o == sp]  # sorted by global id
        self._shifts = []        # ring shifts d
        self._shift_np = []      # (send, recv, mask) [N, S] per shift
        for d in sorted({(dst - sp) % N for (sp, dst) in shared}):
            S = max(len(shared.get((i, (i + d) % N), ())) for i in range(N))
            if S == 0:
                continue
            send = np.zeros((N, S), np.int32)
            recv = np.full((N, S), self.n_ghost_max, np.int32)
            mask = np.zeros((N, S), np.float64)
            for i in range(N):
                lst = shared.get((i, (i + d) % N))
                if lst is not None and len(lst):
                    send[i, :len(lst)] = slot[lst]
                lst2 = shared.get(((i - d) % N, i))
                if lst2 is not None and len(lst2):
                    recv[i, :len(lst2)] = np.searchsorted(ghost[i], lst2)
                    mask[i, :len(lst2)] = 1.0
            self._shifts.append(d)
            self._shift_np.append((send, recv, mask))
        dev = self.device

        def put(a, dtype=torch.long):
            return torch.as_tensor(a, dtype=dtype, device=dev)

        # per shift, this rank's rows: send, recv (padding -> the fill's
        # extra row), recv clamped to the last ghost row (what the JAX
        # package's out-of-range gather reads in the reduction, where the
        # mask then zeroes it), mask
        mine = slice(p0, p0 + L)
        self._shift_tables = [
            (put(s[mine]), put(r[mine]),
             put(np.minimum(r[mine], max(self.n_ghost_max - 1, 0))),
             put(m[mine], torch.float64)) for s, r, m in self._shift_np]
        self._parts = torch.arange(L, device=dev)[:, None]
        # per shift, the forward (+d) and reverse (-d) moves of its rows
        self._moves = [(self._move(d), self._move(-d)) for d in self._shifts]

        # -- BCs in the distributed layout ------------------------------------
        mask_np = system.bcs.mask.cpu().numpy()
        mask_pad = np.concatenate(
            [mask_np, np.ones((1, self.n_eq), bool)])  # phantoms: identity rows
        my_rows = dist_src[self.row0:self.row0 + self.n_rows]
        self.mask_dist = put(mask_pad[my_rows], torch.bool)
        self._dist_src_t = put(my_rows)
        self._slot_of_t = put(slot_of)
        self._dist_ell = None

    def _move(self, d: int):
        """How a roll by `d` of the [N, S, ...] payload reaches this rank's
        parts: None where every part is this rank's (the roll itself),
        else (local: (receiver j, sender i) pairs of this rank's parts;
        recvs: per source rank, the receivers j in order; sends: per
        destination rank, the senders i in the order it receives them)."""
        N, L, p0, R = self.n_parts, self.n_local, self.part0, self.n_ranks
        if R == 1:
            return None

        def source(rank, j):   # the part whose row lands on (rank, j)
            return (rank * L + j - d) % N

        local, recvs, sends = [], {}, {}
        for j in range(L):
            q = source(self.rank, j)
            if q // L == self.rank:
                local.append((j, q - p0))
            else:
                recvs.setdefault(q // L, []).append(j)
        for rank in range(R):
            if rank == self.rank:
                continue
            mine = [source(rank, j) - p0 for j in range(L)
                    if source(rank, j) // L == self.rank]
            if mine:
                sends[rank] = mine
        dev = self.device
        loc = torch.as_tensor(local, dtype=torch.long,
                              device=dev).reshape(-1, 2)
        return (loc[:, 0], loc[:, 1],
                {k: torch.as_tensor(v, device=dev) for k, v in recvs.items()},
                {k: torch.as_tensor(v, device=dev) for k, v in sends.items()})

    def _roll(self, payload: torch.Tensor, d: int, move) -> torch.Tensor:
        """`torch.roll(payload, d, 0)` of the whole [N, S, ...] payload, at
        this rank's parts: the rows from its own parts moved in place, the
        others received from their ranks."""
        if move is None:
            return torch.roll(payload, d, 0)
        dst, src, recvs, sends = move
        out = torch.empty_like(payload)
        out[dst] = payload[src]
        bufs = {k: payload.new_empty((len(j),) + tuple(payload.shape[1:]))
                for k, j in recvs.items()}
        self.group.exchange([(k, payload[i]) for k, i in sends.items()],
                            list(bufs.items()))
        for k, j in recvs.items():
            out[j] = bufs[k]
        return out

    # -- layout conversion ----------------------------------------------------

    def to_dist(self, u) -> torch.Tensor:
        """[n_dofs, ...] (original numbering) -> this rank's rows of
        [N*n_own_max, ...] on the device; phantom rows are zero."""
        u = torch.as_tensor(u, device=self.device)
        pad = u.new_zeros((1,) + tuple(u.shape[1:]))
        return torch.cat([u, pad])[self._dist_src_t]

    def _all_rows(self, ud: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of the distributed layout [N*n_own_max, ...]
        (an all-gather over the group)."""
        return ud if self.group is None else self.group.all_gather_rows(ud)

    def from_dist(self, ud) -> np.ndarray:
        """The distributed array in the original numbering, on the host
        (every rank gets all of it)."""
        return self._all_rows(ud).detach().cpu().numpy()[self._slot_of]

    def gather_global(self, ud: torch.Tensor) -> torch.Tensor:
        """Device-side `from_dist`: the distributed array in the original
        dof numbering. For once-per-accepted-step work like the glow
        model's coefficient interpolation, not for inner loops."""
        return self._all_rows(ud)[self._slot_of_t]

    def scatter_aux(self, aux: Dict) -> Dict:
        """An aux dict of [n_dofs, ...] tensors in the distributed layout
        (non-field entries pass through)."""
        n = len(self._slot_of)

        def conv(v):
            if isinstance(v, torch.Tensor) and v.dim() >= 1 \
                    and v.shape[0] == n:
                return self.to_dist(v)
            return v

        return {k: conv(v) for k, v in aux.items()}

    @property
    def dtype(self):
        return self.inner.dtype

    # -- halo exchange -------------------------------------------------------

    def _halo_fill(self, x: torch.Tensor) -> torch.Tensor:
        """[L*n_own_max, ...] -> [L*n_ext, ...]: each part's owned rows,
        its ghosts filled from their owners (forward exchange) and a zero
        trash row."""
        L, tr = self.n_local, tuple(x.shape[1:])
        xs = x.reshape((L, self.n_own_max) + tr)
        gh = x.new_zeros((L, self.n_ghost_max + 1) + tr)
        for d, (send, recv, _, _), (fwd, _) in zip(
                self._shifts, self._shift_tables, self._moves):
            gh[self._parts, recv] = self._roll(xs[self._parts, send], d, fwd)
        out = torch.cat([xs, gh[:, :self.n_ghost_max],
                         x.new_zeros((L, 1) + tr)], dim=1)
        return out.reshape((L * self.n_ext,) + tr)

    def _halo_reduce(self, r_ext: torch.Tensor) -> torch.Tensor:
        """[L*n_ext, ...] summed scatter -> [L*n_own_max, ...]: the ghost
        rows' sums returned to their owners (reverse exchange)."""
        L, tr = self.n_local, tuple(r_ext.shape[1:])
        rs = r_ext.reshape((L, self.n_ext) + tr)
        r_own = rs[:, :self.n_own_max].clone()
        gh = rs[:, self.n_own_max:self.n_own_max + self.n_ghost_max]
        for d, (send, _, recv_c, mask), (_, rev) in zip(
                self._shifts, self._shift_tables, self._moves):
            payload = gh[self._parts, recv_c] * mask.reshape(
                tuple(mask.shape) + (1,) * len(tr)).to(gh.dtype)
            r_own.index_put_((self._parts.expand_as(send), send),
                             self._roll(payload, -d, rev), accumulate=True)
        return r_own.reshape((L * self.n_own_max,) + tr)

    # -- operators -------------------------------------------------------------

    def _values_dist(self, t) -> torch.Tensor:
        g = self.inner.bcs.values_at(t)
        return torch.cat([g, g.new_zeros((1, self.n_eq))])[self._dist_src_t]

    def operators(self, u_old, u_old1, params: StepParams, dtype=None,
                  aux=None) -> DistOperators:
        return DistOperators(self, u_old, u_old1, params,
                             self.dtype if dtype is None else dtype, aux)

    def residual(self, u, u_old, u_old1, params: StepParams, dtype=None,
                 aux=None):
        """Residual at the absolute distributed state `u`."""
        ops = self.operators(u_old, u_old1, params, dtype, aux)
        return ops.residual((u - u_old).to(ops.dtype))

    # -- distributed elliptic (Poisson-block) preconditioner ---------------------

    def _dist_stiffness_op(self, eq: int):
        """The masked Laplacian of component `eq` on [n_dofs_dist] vectors:
        halo-exchanged local stiffness products (the cell batch only: the
        facet kernels add nothing to the Laplacian), identity on Dirichlet
        and phantom rows. The counterpart of
        `CoupledSystem.masked_stiffness_op`."""
        mask = self.mask_dist[:, eq]
        b = self._batches[0][0]

        def A(x):
            x_in = torch.where(mask, 0.0, x).to(b.dtype)
            Ax = self._halo_reduce(b.scatter(b.stiffness(b.grad(
                b.gather(self._halo_fill(x_in))))))
            return torch.where(mask, x, Ax)

        return A

    def enable_distributed_elliptic(self, eq: int, degree: int = 12,
                                    ratio: float = 30.0,
                                    power_iters: int = 40) -> None:
        """Replace the node-block answer on row `eq` by a Chebyshev solve
        of that component's Laplacian on the distributed layout, in place
        of the replicated solve on the gathered column: a fixed linear
        operator (BiCGStab-safe) in the Jacobi-scaled halo-exchanged
        product."""
        from ..solvers.chebyshev import chebyshev_solver, power_iteration_lmax

        # the Jacobi diagonal of the masked stiffness, assembled on the host
        # in the original numbering (once), then distributed
        b = self.inner.cell_batch
        g = b.grads.cpu().numpy()
        g2 = np.sum(g * g, axis=-1)
        scale = b.scale.cpu().numpy()
        if g2.shape[1] == 1:
            contrib = scale.sum(axis=1)[:, None] * g2[:, 0]
        else:
            contrib = np.einsum("cq,cqa->ca", scale, g2)
        acc = np.zeros(self.inner.n_dofs)
        np.add.at(acc, b.dofs_np.reshape(-1), contrib.reshape(-1))
        mask_np = self.inner.bcs.mask[:, eq].cpu().numpy()
        dtilde = np.where(mask_np | (acc == 0), 1.0, acc)
        dtilde_d = self.to_dist(torch.as_tensor(dtilde, dtype=self.dtype))
        # phantom rows: identity (to_dist zero-fills them)
        dtilde_d = torch.where(dtilde_d == 0, 1.0, dtilde_d)

        A = self._dist_stiffness_op(eq)

        def At(x):
            return A(x) / dtilde_d

        lmax = power_iteration_lmax(
            At, self.n_dofs_dist, iters=power_iters, device=self.device,
            rows=slice(self.row0, self.row0 + self.n_rows), group=self.group)
        cheb = chebyshev_solver(At, lmax / ratio, 1.05 * lmax, degree)
        self._dist_ell = (eq, lambda r: cheb(r / dtilde_d))

    # -- node-block Jacobi preconditioner ----------------------------------------

    def block_precond_builder(self, ops: DistOperators):
        """delta -> M, with M^-1 the inverted node blocks and, on the
        elliptic row, the distributed Chebyshev solve
        (`enable_distributed_elliptic`) or else the inner system's solve
        on the gathered column (replicated, scattered back)."""
        ell = self.inner._ell

        def build(delta):
            inv = invert_blocks(ops.jacobian_blocks(delta))
            if self._dist_ell is not None:
                eq, ell_solve = self._dist_ell

                def M_dist(r):
                    y = block_apply(inv, r)
                    y[:, eq] = ell_solve(r[:, eq]).to(y.dtype)
                    return y

                return M_dist
            if ell is None:
                return lambda r: block_apply(inv, r)
            eq, ell_solve = ell

            def M(r):
                y = block_apply(inv, r)
                y_col = ell_solve(self.gather_global(r[:, eq]))
                y[:, eq] = torch.cat([y_col, y_col.new_zeros(1)])[
                    self._dist_src_t].to(y.dtype)
                return y

            return M

        return build

    # -- one attempted BDF step ---------------------------------------------------

    def step(self, u_guess, u_old, u_old1, aux, params: StepParams):
        """One attempted nonlinear solve at (t, dt) from
        delta = u_guess - u_old by `newton_krylov`. Returns
        (u_new, NewtonInfo)."""
        ops = self.operators(u_old, u_old1, params, aux=aux)
        delta = (u_guess - u_old).to(self.dtype)
        delta, info = newton_krylov(ops.residual, ops.jacobian_action, delta,
                                    self.newton,
                                    self.block_precond_builder(ops),
                                    group=self.group)
        return u_old + delta.to(u_old.dtype), info


def part_checksum(part: np.ndarray) -> int:
    """sum_i (i + 1) * part[i]: the checksum of a partition that the ranks
    compare (and the JAX package's reference numbers record)."""
    return int(np.sum((np.arange(len(part)) + 1) * part.astype(np.int64)))


def distribute(system: CoupledSystem, devices: Sequence,
               group=None) -> DistributedSystem:
    return DistributedSystem(system, devices, group)
