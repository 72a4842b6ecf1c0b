"""User-facing Model and its optimize() entry point.

Counterpart of ``tulip_tpu/model.py``: presolve → standard form → IPM →
solution extraction → postsolve (reference: src/model.jl:67-154). The
numpy helpers (``_trivial_solve``, ``_certificate_tol``,
``_validate_certificates``, ``_extract_solution``) are verbatim copies.

The IPM runs on ``Model(device=...)`` (default ``"cuda"``); ``Parameters``
is shared with the JAX package byte for byte, so the device is not one
of its fields. ``IPM.Algorithm`` picks HSD or MPC.

Routing follows the reference's (``tulip_tpu/model.py:134-255``), and
every route it takes at its defaults is ported:

- sparse-first: from ``KKT.SparseFirstThreshold`` rows (or with
  ``KKT.SparseFirst=True``) the standard form goes straight from COO into
  compressed tiles (``ipm/sparse_data.py``) and solves through
  ``"sparse"``, or ``"sparse-smw"`` when dense columns were split out; no
  dense (m, n) array is built, on the host or on the device;
- else, at m >= 2048 with no backend named, the structure probe
  (``_probe_structure``, a verbatim copy) picks ``"banded"``, ``"sparse"``,
  ``"sparse-smw"`` or, for many or dominant dense columns, the tiled K2
  ``"sparse-ldl"``, or keeps the dense default; its answer is cached on
  the model under a pattern and norm fingerprint of A. The probe and the
  structured backends' ``setup`` read the standard-form A on the host,
  cast to the solve's dtype, before anything is copied to the device;
- ``KKT.System="K2"`` takes ``"dense-ldl"`` below m = 2048 and
  ``"sparse-ldl"`` from there (which falls back to ``"dense-ldl"`` where
  tiling gives no advantage);
- f32 on the card with no backend named takes ``"pallas-small"`` (the
  chol-inv kernel); f64 with a tolerance below 1e-9 takes ``"extended"``
  (double-double refinement).

A named backend takes the dense data path, as in the reference (only
``None``, ``"sparse"`` and ``"sparse-smw"`` may go sparse-first); the
Krylov family (``kkt/krylov.py``) runs with no refinement sweep by
default. ``"schur"`` solves block-angular data only
(``parallel.BlockAngularLPData`` through ``ipm.hsd_solve``), so naming
it here raises ``TypeError`` before any device work.
"""

from __future__ import annotations

import contextlib
import os
import time
from functools import partial
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from .ipm.data import make_lp_data, standard_form_arrays
from .ipm.hsd import HSDOptions, hsd_solve
from .ipm.mpc import MPCOptions, mpc_solve
from .ipm.sparse_data import (sparse_lp_data_from_problem,
                              sparse_pattern_signals)
from .kkt import make_backend
from .params import Parameters
from .presolve import PresolveData, postsolve
from .problem import ProblemData
from .solution import Solution
from .status import SolutionStatus, TerminationStatus

# The arithmetic dtypes the port computes in, numpy name -> torch.
TORCH_DTYPES = {np.dtype(np.float32): torch.float32,
                np.dtype(np.float64): torch.float64}

# Rows from which the reference probes a large problem's structure when no
# backend is named (tulip_tpu/model.py:176-177).
_PROBE_MIN_ROWS = 2048
# Backends whose setup reads A on the host (given as ``host_A``).
_HOST_SETUP = ("banded", "sparse", "sparse-smw", "sparse-ldl")


class Model:
    """LP model: parameters + problem data + (after optimize) solution
    (reference: src/model.jl:1-37). ``device`` places the IPM."""

    def __init__(self, params: Optional[Parameters] = None, *,
                 device="cuda"):
        self.params = params or Parameters()
        self.device = torch.device(device)
        self.status = TerminationStatus.NOT_CALLED
        self.pbdata = ProblemData()
        self.presolve_data: Optional[PresolveData] = None
        self.solver_state = None  # final IPM state (batch-of-one tensors)
        self.solution: Optional[Solution] = None
        self.solve_time = 0.0
        self.barrier_iterations = 0
        self.kkt_backend = None  # backend instance used by the last solve
        self._probe_cache = None  # (pattern fingerprint, backend name)
        # Per-phase wall-clock seconds: presolve / standard_form / ipm /
        # extract / postsolve (the reference's TimerOutputs analogue).
        self.timings: dict = {}

    def empty(self) -> None:
        """Reset to an empty model (reference: src/model.jl:52-60)."""
        self.pbdata = ProblemData()
        self.status = TerminationStatus.NOT_CALLED
        self.presolve_data = None
        self.solver_state = None
        self.solution = None
        self.solve_time = 0.0
        self.barrier_iterations = 0
        self._probe_cache = None

    # ------------------------------------------------------------------
    def optimize(self) -> TerminationStatus:
        """Solve the problem (reference: src/model.jl:67-154)."""
        t0 = time.time()
        self.timings = {}
        params = self.params
        pb = self.pbdata

        if params.OutputLevel > 0:
            print("\nProblem info")
            print(f"  Name        : {pb.name}")
            print(f"  Constraints : {pb.ncon}")
            print(f"  Variables   : {pb.nvar}")
            print(f"  Non-zeros   : {pb.nnz}")

        pb_ = pb
        self.presolve_data = None
        if params.Presolve.Level > 0:
            t_ = time.time()
            ps = PresolveData(pb, params.Presolve)
            engine = getattr(params.Presolve, "Engine", "auto")
            st = None
            if engine in ("auto", "native"):
                from .presolve.native import presolve_native
                st = presolve_native(ps)
                if st is None and engine == "native":
                    raise RuntimeError("native presolve engine unavailable")
            if st is None:
                st = ps.presolve()
            if st in (TerminationStatus.PRIMAL_INFEASIBLE,
                      TerminationStatus.DUAL_INFEASIBLE):
                st = ps.upgrade_if_both_infeasible()
            self.timings["presolve"] = time.time() - t_
            self.presolve_data = ps
            if st in (TerminationStatus.OPTIMAL,
                      TerminationStatus.PRIMAL_INFEASIBLE,
                      TerminationStatus.DUAL_INFEASIBLE,
                      TerminationStatus.PRIMAL_DUAL_INFEASIBLE):
                # Presolve solved the problem (reference: model.jl:105-119).
                sol0 = Solution(pb.ncon, pb.nvar)
                postsolve(sol0, ps.solution, ps)
                _validate_certificates(pb, sol0,
                                       tol=_certificate_tol(params))
                self.solution = sol0
                self.status = st
                self.solve_time = time.time() - t0
                return self.status
            pb_ = ps.extract_reduced_arrays()
            if params.OutputLevel > 0:
                print("\nReduced problem info")
                print(f"  Constraints : {ps.nrow}  "
                      f"(removed {pb.ncon - ps.nrow})")
                print(f"  Variables   : {ps.ncol}  "
                      f"(removed {pb.nvar - ps.ncol})")
                print(f"  Non-zeros   : {pb_.nnz}")

        if pb_.nvar == 0 or pb_.ncon == 0:
            # Degenerate shapes the IPM cannot take: closed-form solve.
            sol_inner, st = _trivial_solve(pb_)
            self.barrier_iterations = 0
            if params.Presolve.Level > 0:
                sol_outer = Solution(pb.ncon, pb.nvar)
                postsolve(sol_outer, sol_inner, self.presolve_data)
                self.solution = sol_outer
            else:
                self.solution = sol_inner
            _validate_certificates(pb, self.solution,
                                   tol=_certificate_tol(params))
            self.status = st
            self.solve_time = time.time() - t0
            return self.status

        dtype = np.dtype(params.ArithmeticDtype)
        if dtype not in TORCH_DTYPES:
            raise ValueError(f"ArithmeticDtype {params.ArithmeticDtype!r}: "
                             "the port computes in float32 or float64")
        t_ = time.time()
        # The sparse-first attempt comes before any dense (m, n) array.
        dat = self._sparse_first(pb_, dtype)
        A_host = None
        if dat is None:
            A, b, c, c0, l, u, _ = standard_form_arrays(pb_)
            # The probe and a structured backend's setup read A here, in
            # the solve's dtype (as the reference reads its device array
            # back).
            A_host = A.astype(dtype, copy=False)
        t_route = time.time()
        backend, ipm_opts = self._route(pb_, dtype, A_host, sparse=dat)
        t_route = time.time() - t_route
        if dat is None:
            dat = make_lp_data(A_host, b, c, c0, l, u, device=self.device,
                               dtype=TORCH_DTYPES[dtype])
        n_struct = pb_.nvar
        self.timings["standard_form"] = time.time() - t_ - t_route

        try:
            state = self._run_ipm(dat, backend, ipm_opts, params)
        except KeyboardInterrupt:
            # User interrupt: report UNKNOWN instead of crashing
            # (reference: src/IPM/HSD/HSD.jl:330-333).
            self.status = TerminationStatus.UNKNOWN
            self.solve_time = time.time() - t0
            return self.status
        except Exception as e:
            if _is_oom(e):
                # Memory exhausted mid-solve (reference: HSD.jl:325-328).
                self.status = TerminationStatus.MEMORY_LIMIT
                self.solve_time = time.time() - t0
                return self.status
            raise

        self.solver_state = state
        self.barrier_iterations = int(state.niter)

        # Extract solution in (reduced) original space.
        t_ = time.time()
        sol_inner = Solution(pb_.ncon, pb_.nvar)
        _extract_solution(sol_inner, pb_, _host_lane(_to_numpy(state), 0),
                          n_struct)
        self.timings["extract"] = time.time() - t_

        if params.Presolve.Level > 0:
            t_ = time.time()
            sol_outer = Solution(pb.ncon, pb.nvar)
            postsolve(sol_outer, sol_inner, self.presolve_data)
            self.timings["postsolve"] = time.time() - t_
            self.solution = sol_outer
        else:
            self.solution = sol_inner
        _validate_certificates(pb, self.solution,
                               tol=_certificate_tol(params, dtype))

        self.status = TerminationStatus(int(state.status))
        self.solve_time = time.time() - t0
        return self.status

    def _sparse_first(self, pb_, dtype: np.dtype):
        """The sparse-first ``SparseLPData`` of the reduced problem on the
        model's device, or None where the reference keeps the dense data
        (``tulip_tpu/model.py:138-174``): the attempt is forced by
        ``KKT.SparseFirst=True``, or made from ``SparseFirstThreshold``
        rows when the O(nnz) pattern signals say that A tiles (density
        below 0.1, and no dense column or at most 8 whose norms do not
        dominate); it gives None when the tile plan does."""
        params = self.params
        if (params.KKT.SparseFirst is False
                or params.KKT.System not in (None, "K1")
                or params.KKT.Backend not in (None, "sparse", "sparse-smw")):
            return None
        attempt = params.KKT.SparseFirst is True
        if not attempt and pb_.ncon >= params.KKT.SparseFirstThreshold:
            sig = sparse_pattern_signals(pb_)
            smw_ok = (sig["n_dense_cols"] == 0
                      or (sig["n_dense_cols"] <= 8
                          and sig["dense_norm_ratio"] <= 30.0))
            attempt = sig["density"] < 0.1 and smw_ok
        if not attempt:
            return None
        res = sparse_lp_data_from_problem(pb_, dtype=TORCH_DTYPES[dtype],
                                          device=self.device)
        return None if res is None else res[0]

    def _route(self, pb_, dtype: np.dtype, A_host: Optional[np.ndarray],
               sparse=None):
        """(KKT backend, resolved IPM options) for the reduced problem
        (``tulip_tpu/model.py:134-255``). ``sparse`` is the problem's
        sparse-first data, when :meth:`_sparse_first` gave it; else
        ``A_host`` is its standard-form constraint matrix. Host work
        only."""
        params = self.params
        backend_name = params.KKT.Backend
        system = params.KKT.System
        if sparse is not None:
            backend_name = "sparse-smw" if sparse.U.shape[-1] else "sparse"
        if backend_name is None and system in (None, "K1") \
                and A_host.shape[0] >= _PROBE_MIN_ROWS:
            backend_name = self._probe(A_host)
        if backend_name is None and system == "K2" \
                and pb_.ncon >= _PROBE_MIN_ROWS:
            # The tiled signed Cholesky on K2 (the reference's default
            # there, model.py:207-214).
            backend_name = "sparse-ldl"
        if backend_name is None and system in (None, "K1") \
                and dtype == np.float32 and self.device.type == "cuda":
            # The f32 fast path on the accelerator: the chol-inv kernel
            # (the reference takes it on the TPU, model.py:215-221).
            backend_name = "pallas-small"
        ipm_opts = params.IPM.resolved(dtype)
        if backend_name is None and system in (None, "K1") \
                and dtype == np.float64 \
                and min(ipm_opts.TolerancePFeas, ipm_opts.ToleranceDFeas,
                        ipm_opts.ToleranceRGap,
                        ipm_opts.ToleranceIFeas) < 1e-9:
            # Tolerances beyond f64's sqrt(eps): double-double-residual
            # refinement (model.py:223-231).
            backend_name = "extended"
        refinement = params.KKT.RefinementSteps
        if refinement is None:
            # Per-backend defaults, as in the reference (model.py:232-254).
            refinement = {"sparse-smw": 2, "sparse-ldl": 2,
                          "pallas-small": 1, "extended": 2,
                          "extended-dd": 1}.get(backend_name or "", 0)
            if sparse is not None:
                # The level engine's inverse-factor solves lose a digit or
                # two against triangular solves: one sweep on the true
                # system at least (model.py:250-254).
                refinement = max(refinement, 1)
        kwargs = {"host_A": A_host} if backend_name in _HOST_SETUP else {}
        backend = make_backend(backend_name, system, refinement, **kwargs)
        if backend.lp_data_refusal is not None:
            # The reference fails later, in the backend's setup_data
            # (AttributeError on LPData; ROADMAP queue 3).
            raise TypeError(backend.lp_data_refusal)
        if params.IPM.Algorithm.upper() not in ("HSD", "MPC"):
            raise ValueError(f"Unknown IPM algorithm {params.IPM.Algorithm!r}")
        # Introspection: which linear solver ran (reference: HSD.jl:214-230).
        self.kkt_backend = backend
        return backend, ipm_opts

    def _probe(self, A_np: np.ndarray):
        """The structure probe's answer for ``A_np``, cached under the
        reference's key (``tulip_tpu/model.py:186-206``): the shape, the
        nonzero counts of each column and row, and a quantized
        norm-dominance signal, so that an edit of the objective or the
        bounds re-optimises without probing again."""
        nz = A_np != 0
        cnorm = np.linalg.norm(A_np, axis=0)
        med = float(np.median(cnorm[cnorm > 0])) if nz.any() else 1.0
        norm_sig = int(np.log2(max(float(cnorm.max()), 1e-300)
                               / max(med, 1e-300)) * 4.0)
        key = (A_np.shape,
               hash(nz.sum(axis=0).tobytes()),
               hash(nz.sum(axis=1).tobytes()),
               norm_sig)
        if self._probe_cache is not None and self._probe_cache[0] == key:
            return self._probe_cache[1]
        name = _probe_structure(A_np)
        self._probe_cache = (key, name)
        return name

    def _run_ipm(self, dat, backend, ipm_opts, params):
        """HSD or MPC with options built as the reference builds them
        (``tulip_tpu/model.py:324-367``)."""
        common = dict(
            TolerancePFeas=ipm_opts.TolerancePFeas,
            ToleranceDFeas=ipm_opts.ToleranceDFeas,
            ToleranceRGap=ipm_opts.ToleranceRGap,
            ToleranceIFeas=ipm_opts.ToleranceIFeas,
            IterationsLimit=ipm_opts.IterationsLimit,
            TimeLimit=ipm_opts.TimeLimit,
            CorrectionLimit=ipm_opts.CorrectionLimit,
            StepDampFactor=ipm_opts.StepDampFactor,
            GammaMin=ipm_opts.GammaMin,
            PRegMin=ipm_opts.PRegMin,
            DRegMin=ipm_opts.DRegMin,
            OutputLevel=max(params.OutputLevel, ipm_opts.OutputLevel),
        )
        if params.IPM.Algorithm.upper() == "MPC":
            run = partial(mpc_solve, dat, backend, MPCOptions(**common))
        else:
            run = partial(hsd_solve, dat, backend, HSDOptions(
                **common,
                CentralityOutlierThreshold=(
                    ipm_opts.CentralityOutlierThreshold),
                MehrotraStart=ipm_opts.MehrotraStart,
                FastPredictor=ipm_opts.FastPredictor,
                FastCorrections=ipm_opts.FastCorrections))
        t_ = time.time()
        with _profile_trace(params.ProfileDir, self.device):
            state = run()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.timings["ipm"] = time.time() - t_
        return state


@contextlib.contextmanager
def _profile_trace(profile_dir: str, device: torch.device):
    """Run the body under ``torch.profiler`` and write a Chrome trace to
    ``<profile_dir>/ipm_trace.json`` (the counterpart of the reference's
    ``jax.profiler.trace``); a no-op when ``profile_dir`` is empty."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(profile_dir, "ipm_trace.json"))


def _to_numpy(state) -> SimpleNamespace:
    """The fields of a solved batch that extraction reads, on the host."""
    def h(t):
        return t.cpu().numpy()

    pt = state.pt
    return SimpleNamespace(
        status=h(state.status), niter=h(state.niter),
        primal_status=h(state.primal_status),
        dual_status=h(state.dual_status),
        pobj=h(state.pobj), dobj=h(state.dobj),
        pt=SimpleNamespace(x=h(pt.x), zl=h(pt.zl), zu=h(pt.zu), y=h(pt.y),
                           tau=h(pt.tau)))


def _host_lane(state, pos: int, m: Optional[int] = None,
               n: Optional[int] = None) -> SimpleNamespace:
    """Lane ``pos`` of :func:`_to_numpy`'s output as the unbatched host
    state ``_extract_solution`` reads, cut to the lane's own m rows and n
    columns when the batch was padded."""
    pt = state.pt
    return SimpleNamespace(
        pt=SimpleNamespace(x=pt.x[pos, :n], zl=pt.zl[pos, :n],
                           zu=pt.zu[pos, :n], y=pt.y[pos, :m],
                           tau=pt.tau[pos]),
        primal_status=state.primal_status[pos],
        dual_status=state.dual_status[pos],
        pobj=state.pobj[pos], dobj=state.dobj[pos])


def _is_oom(e: Exception) -> bool:
    """Device or host memory exhaustion: ``MemoryError``, torch's CUDA
    out-of-memory error, or a library error that says so."""
    if isinstance(e, (MemoryError, torch.cuda.OutOfMemoryError)):
        return True
    return "OUT OF MEMORY" in str(e).upper()


def _trivial_solve(pb_):
    """Closed-form solve for no-variable / no-constraint problems."""
    ncon, nvar = pb_.ncon, pb_.nvar
    sol = Solution(ncon, nvar)
    if nvar == 0:
        lcon = np.asarray(pb_.lcon, dtype=float)
        ucon = np.asarray(pb_.ucon, dtype=float)
        bad_lo = np.isfinite(lcon) & (lcon > 0.0)
        bad_hi = np.isfinite(ucon) & (ucon < 0.0)
        if bad_lo.any() or bad_hi.any():
            i = int(np.flatnonzero(bad_lo | bad_hi)[0])
            sol.dual_status = SolutionStatus.INFEASIBILITY_CERTIFICATE
            sol.is_dual_ray = True
            if bad_lo[i]:
                sol.y_lower[i] = 1.0
            else:
                sol.y_upper[i] = 1.0
            sol.z_primal = sol.z_dual = np.inf
            return sol, TerminationStatus.PRIMAL_INFEASIBLE
        sol.primal_status = SolutionStatus.OPTIMAL
        sol.dual_status = SolutionStatus.OPTIMAL
        sol.z_primal = sol.z_dual = pb_.obj0
        return sol, TerminationStatus.OPTIMAL

    # ncon == 0: bounds-only LP (internal min-sense duals, like the IPM).
    sense = 1.0 if pb_.objsense else -1.0
    c = sense * np.asarray(pb_.obj, dtype=float)
    lvar = np.asarray(pb_.lvar, dtype=float)
    uvar = np.asarray(pb_.uvar, dtype=float)
    unb = ((c > 0) & ~np.isfinite(lvar)) | ((c < 0) & ~np.isfinite(uvar))
    if unb.any():
        j = int(np.flatnonzero(unb)[0])
        sol.primal_status = SolutionStatus.INFEASIBILITY_CERTIFICATE
        sol.is_primal_ray = True
        sol.x[j] = 1.0 if c[j] < 0 else -1.0
        sol.z_primal = sol.z_dual = -np.inf
        return sol, TerminationStatus.DUAL_INFEASIBLE
    if bool(np.any(lvar > uvar)):
        j = int(np.flatnonzero(lvar > uvar)[0])
        sol.dual_status = SolutionStatus.INFEASIBILITY_CERTIFICATE
        sol.is_dual_ray = True
        sol.s_lower[j] = 1.0
        sol.s_upper[j] = 1.0
        sol.z_primal = sol.z_dual = np.inf
        return sol, TerminationStatus.PRIMAL_INFEASIBLE
    sol.x[:] = np.where(c > 0, lvar,
                        np.where(c < 0, uvar, np.clip(0.0, lvar, uvar)))
    sol.s_lower[:] = np.maximum(c, 0.0)
    sol.s_upper[:] = np.maximum(-c, 0.0)
    sol.primal_status = SolutionStatus.OPTIMAL
    sol.dual_status = SolutionStatus.OPTIMAL
    z = float(c @ sol.x)
    sol.z_primal = sol.z_dual = z + pb_.obj0 * sense
    return sol, TerminationStatus.OPTIMAL


def _probe_structure(A_np: np.ndarray) -> Optional[str]:
    """Pick a structure-exploiting backend for a large problem, or None
    for the dense default.

    Order (cheapest signal first): dense columns → tiled sparse Cholesky
    + SMW splitting (a dense column fills K1 = AΘAᵀ completely; the
    role the reference covers by defaulting to CHOLMOD-on-K2,
    reference: src/KKT/KKT.jl:134-141); else banded when RCM finds a
    narrow band (pure staircases); else tiled-sparse K1 when the filled
    tile pattern is sparse (cyclic/corner coupling). All three backends
    re-fall-back internally."""
    from .kkt.sparse import tile_plan
    from .kkt.sparse_ldl import dense_threshold

    m, n = A_np.shape
    colnnz = (np.abs(A_np) > 0).sum(axis=0)

    # Density early-out FIRST: a matrix this dense cannot band or tile
    # whatever its dense-column count (the planners' gates would reject
    # it after much more host work), and routing it to a K2 backend
    # would end at dense-ldl on the (n+m)-sized augmented system —
    # strictly worse than dense K1.
    if int(colnnz.sum()) > 0.2 * m * n:
        return None

    dense_cols = colnnz >= dense_threshold(m)
    if bool(np.any(dense_cols)):
        k = int(dense_cols.sum())
        if k > max(64, 0.02 * n):
            # Too many "dense" columns to be structure + exceptions
            # (the SMW backend's own cap): dense K1.
            return None
        As = A_np.copy()
        As[:, np.flatnonzero(dense_cols)] = 0.0
        if tile_plan(As, 128) is None:
            return None  # dense cols and no residual sparsity: dense K1
        # Measured smw-vs-sparse-ldl routing (round 4; m=2048 staircase +
        # k dense columns, HSD f64 @1e-8, presolve scaling on, 2 sweeps
        # both): smw matches ldl's iteration counts at k <= 8 with
        # moderate column norms (15-18 iters) but STALLS at
        # ITERATION_LIMIT at k = 24 (any norms) and at k = 8 when the
        # dense columns' norms dominate (post-scaling norm ratio ~60) —
        # the rank-k SMW correction loses the forward accuracy that two
        # refinement sweeps can recover. The direct K2 factorization
        # (kappa(K2) = sqrt(kappa(K1))) solved every case in 15-18
        # iterations. Route by dense-column count and the measured
        # norm-dominance signal; prefer smw inside its validated regime
        # (it benches 6.1 vs 14.1 ms/iter at m=8192).
        cnorm = np.linalg.norm(A_np, axis=0)
        sparse_norms = cnorm[~dense_cols]
        med = float(np.median(sparse_norms)) if sparse_norms.size else 1.0
        ratio = float(cnorm[dense_cols].max() / max(med, 1e-300))
        if k > 8 or (k >= 4 and ratio > 30.0):
            return "sparse-ldl"
        return "sparse-smw"

    from .kkt.banded import rcm_bandwidth

    _, bw = rcm_bandwidth(A_np)
    bw_block = max(128, -(-max(bw, 1) // 128) * 128)
    if 2 * bw_block <= m // 4:
        return "banded"
    if tile_plan(A_np, 128) is not None:
        return "sparse"
    return None


def _certificate_tol(params, dtype=None) -> float:
    """Validation gate scaled from the solve's resolved tolerances
    (round-4 review: a hard-coded 1e-5 gated an f32 @3e-4 run and an
    extended @1e-12 run identically). The IPM certifies rays at
    ~ToleranceIFeas in scaled norms; a 100x margin absorbs the
    postsolve/unscaling amplification, floored at 1e3·eps(dtype)."""
    import numpy as np
    dtype = np.dtype(dtype or params.ArithmeticDtype)
    ifeas = params.IPM.resolved(dtype).ToleranceIFeas
    return max(100.0 * float(ifeas), 1e3 * float(np.finfo(dtype).eps))


def _validate_certificates(pb: ProblemData, sol: Solution,
                           tol: float = 1e-5) -> None:
    """Drop ray claims that do not verify in the original space.

    Termination statuses stay as decided (they are certified by the dual
    reasoning that produced them); but a claimed certificate VECTOR must
    satisfy its defining inequalities, which presolve reductions cannot
    always reconstruct (e.g. a dominated-column dual-infeasibility
    conclusion on a both-primal-and-dual-infeasible LP has no primal ray
    at all). The reference reports such junk rays as certificates
    (reference: dominated_column.jl:46); we report UNKNOWN instead.
    """
    if not (sol.is_primal_ray or sol.is_dual_ray):
        return
    # Vectorized over the COO export: flat per-solve host cost at any
    # problem size (the bincount pattern of _extract_solution).
    I, J, V = pb.to_coo()
    lcon = np.asarray(pb.lcon, dtype=float)
    ucon = np.asarray(pb.ucon, dtype=float)
    lvar = np.asarray(pb.lvar, dtype=float)
    uvar = np.asarray(pb.uvar, dtype=float)

    if sol.is_primal_ray:
        d = sol.x
        nrm = max(1.0, float(np.max(np.abs(d))) if len(d) else 1.0)
        ad = (np.bincount(I, V * d[J], minlength=pb.ncon)
              if len(I) else np.zeros(pb.ncon))
        ok = not (bool(np.any(np.isfinite(lcon) & (ad < -tol * nrm)))
                  or bool(np.any(np.isfinite(ucon) & (ad > tol * nrm)))
                  or bool(np.any(np.isfinite(lvar) & (d < -tol * nrm)))
                  or bool(np.any(np.isfinite(uvar) & (d > tol * nrm))))
        sense = 1.0 if pb.objsense else -1.0
        if sense * float(np.dot(np.asarray(pb.obj), d)) >= -tol * nrm:
            ok = False
        if not ok:
            sol.is_primal_ray = False
            sol.primal_status = SolutionStatus.UNKNOWN

    if sol.is_dual_ray:
        y = sol.y_lower - sol.y_upper
        s = sol.s_lower - sol.s_upper
        nrm = max(1.0,
                  float(np.max(np.abs(y))) if len(y) else 1.0,
                  float(np.max(np.abs(s))) if len(s) else 1.0)
        resid = s + (np.bincount(J, V * y[I], minlength=pb.nvar)
                     if len(I) else 0.0)
        ok = bool(np.max(np.abs(resid)) <= tol * nrm) if len(resid) else True
        if (bool(np.any((sol.y_lower > tol * nrm) & ~np.isfinite(lcon)))
                or bool(np.any((sol.y_upper > tol * nrm)
                               & ~np.isfinite(ucon)))
                or bool(np.any((sol.s_lower > tol * nrm)
                               & ~np.isfinite(lvar)))
                or bool(np.any((sol.s_upper > tol * nrm)
                               & ~np.isfinite(uvar)))):
            ok = False
        val = (float(sol.y_lower @ np.where(np.isfinite(lcon), lcon, 0.0))
               - float(sol.y_upper @ np.where(np.isfinite(ucon), ucon, 0.0))
               + float(sol.s_lower @ np.where(np.isfinite(lvar), lvar, 0.0))
               - float(sol.s_upper @ np.where(np.isfinite(uvar), uvar, 0.0)))
        if val <= tol * nrm:
            ok = False
        if not ok:
            sol.is_dual_ray = False
            sol.dual_status = SolutionStatus.UNKNOWN


def _extract_solution(sol: Solution, pb: ProblemData, state,
                      n_struct: int) -> None:
    """Map the standard-form iterate back to the general-form problem
    (reference: src/model.jl:156-215): drop slack columns, divide by τ
    unless the point is a certificate ray, sign-split row duals."""
    pt = state.pt
    n = n_struct

    sol.primal_status = SolutionStatus(int(state.primal_status))
    sol.dual_status = SolutionStatus(int(state.dual_status))
    is_primal_ray = sol.primal_status == SolutionStatus.INFEASIBILITY_CERTIFICATE
    is_dual_ray = sol.dual_status == SolutionStatus.INFEASIBILITY_CERTIFICATE
    sol.is_primal_ray = is_primal_ray
    sol.is_dual_ray = is_dual_ray
    tau_inv = 1.0 if (is_primal_ray or is_dual_ray) else 1.0 / float(pt.tau)

    x = np.asarray(pt.x)
    zl = np.asarray(pt.zl)
    zu = np.asarray(pt.zu)
    y = np.asarray(pt.y)

    sol.x[:] = x[:n] * tau_inv
    sol.s_lower[:] = zl[:n] * tau_inv
    sol.s_upper[:] = zu[:n] * tau_inv
    sol.y_lower[:] = np.maximum(y, 0.0) * tau_inv
    sol.y_upper[:] = np.maximum(-y, 0.0) * tau_inv

    # Row activity in original space (COO bincount: works for both
    # ProblemData and the vectorized ReducedArrays container).
    I, J, V = pb.to_coo()
    if len(I):
        sol.Ax[:] = np.bincount(I, V * np.asarray(sol.x)[J],
                                minlength=pb.ncon)
    else:
        sol.Ax[:] = 0.0

    pobj = float(state.pobj)
    dobj = float(state.dobj)
    if sol.primal_status == SolutionStatus.INFEASIBILITY_CERTIFICATE:
        sol.z_primal = -np.inf
        sol.z_dual = -np.inf
    elif sol.primal_status in (SolutionStatus.OPTIMAL,
                               SolutionStatus.FEASIBLE_POINT):
        sol.z_primal = pobj
    else:
        sol.z_primal = np.nan

    if sol.dual_status == SolutionStatus.INFEASIBILITY_CERTIFICATE:
        sol.z_primal = np.inf
        sol.z_dual = np.inf
    elif sol.dual_status in (SolutionStatus.OPTIMAL,
                             SolutionStatus.FEASIBLE_POINT):
        sol.z_dual = dobj
    else:
        sol.z_dual = np.nan
