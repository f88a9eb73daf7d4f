"""KID-gated admission: score a request's disclosure before it takes a slot
(counterpart of ``repro/serve/admission.py``).

CollaFuse's privacy claim is that the disclosed tensor — x at the cut, the
one tensor that crosses from server to client — conceals client data.  The
engine admits requests at any cut-ratio, so without a gate a c → 0 request
walks the server segment almost to x_0.  This module makes the offline
disclosure metric (:mod:`repro_torch.core.privacy`) an online guarantee:

* :class:`AdmissionPolicy` scores the disclosure KID of every would-be
  (sampler, cut position): the calibration batch noised to x_T and denoised
  over positions [0, pos) under the request's sampler, its features against
  the calibration batch's.  HIGH KID = concealed; LOW KID = leaky.
* A request whose score clears ``min_kid`` is ADMITTED at its nominal cut;
  one below it is BUMPED to the next noisier position that clears; if none
  does, it is REJECTED with a typed :class:`AdmissionDecision`.
* Scores are cached per (sampler, position, guidance w) and decisions per
  (sampler, cut_ratio), so gating costs O(menu × cuts) model work whatever
  the traffic.  Guided samplers are scored on the guided trajectory; at
  w = 0 it is bitwise the unguided one.
* A weight swap (a rebound server model that disagrees with the bound one)
  bumps ``params_version`` and clears every cached score and decision.

One change of method against the reference, with the same numbers: the
reference computes each (sampler, pos) from scratch, so a profile up to
position p costs p(p+1)/2 model calls.  Here a position's noise does not
depend on where the chain stops (as in the reference, whose
``sample_trajectory`` splits the carried key each step), so
:meth:`AdmissionPolicy.disclosure_kid` runs ONE chain per (sampler, w),
continuing from the deepest x it holds, and scores and caches every
position it passes: p model calls (2p guided).  Each step is the same call
on the same tensors as a from-scratch
:func:`~repro_torch.core.collafuse.disclosed_at_pos`, so each score is
bitwise the from-scratch one.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Dict, List, Optional

import torch

from repro_torch.core import privacy
from repro_torch.core.collafuse import (CutPlan, NoiseSource,
                                        disclosure_start)
from repro_torch.diffusion.backend import BackendLike
from repro_torch.diffusion.sampler import (Sampler, assert_same_menu,
                                           sample_trajectory)
from repro_torch.diffusion.schedule import DiffusionSchedule
from repro_torch.obs.trace import NULL_TRACER

ADMIT, BUMP, REJECT = "admit", "bump", "reject"
# the noise seed of every calibration chain (the reference's PRNGKey(4242))
CALIB_SEED = 4242


@dataclasses.dataclass(frozen=True)
class AdmissionDecision:
    """The typed outcome of gating one request.

    ``effective_cut`` is the trajectory position the request is served at:
    ``nominal_cut`` for admits, smaller (noisier disclosure, fewer server
    steps) for bumps, -1 for rejects.  ``kid`` is the disclosure KID at the
    effective cut; for a reject, the best score the scan found.
    """

    req_id: int
    sampler: str
    cut_ratio: float
    nominal_cut: int
    effective_cut: int
    kid: float
    min_kid: float
    action: str                      # "admit" | "bump" | "reject"

    @property
    def served(self) -> bool:
        return self.action != REJECT

    @property
    def bumped(self) -> bool:
        return self.action == BUMP

    def describe(self) -> str:
        if self.action == REJECT:
            return (f"reject {self.sampler!r} c={self.cut_ratio:.2f}: best "
                    f"disclosure KID {self.kid:.4f} < floor "
                    f"{self.min_kid:.4f}")
        tag = (f"bump cut {self.nominal_cut}→{self.effective_cut}"
               if self.bumped else f"admit at cut {self.nominal_cut}")
        return (f"{tag} ({self.sampler!r} c={self.cut_ratio:.2f}, "
                f"KID {self.kid:.4f} ≥ {self.min_kid:.4f})")


class AdmissionPolicy:
    """Privacy gate for the serving engine: a disclosure-KID floor + bump.

    ``calib`` is a small (N, H, W, C) batch of real-data stand-ins, N ≥ 2
    (the unbiased KID needs two), on the device the engine serves on.
    ``min_kid`` is the floor every served request's disclosure KID clears.
    ``samplers``, ``server_fn`` (x, t) and ``cond_server_fn`` (x, t, y) may
    be left unset and bound by the engine (:meth:`bind`).  ``noise`` is the
    calibration chains' noise source (default
    :data:`~repro_torch.core.collafuse.lane_philox`, the engine's), drawn
    at seed :data:`CALIB_SEED`, so every score and decision is
    deterministic.

    ``model_calls`` counts the server-model calls scoring made on the
    calibration batch, ``cache_hits`` the scores served from the cache, and
    ``score_s`` the wall time scoring took (each score is read back to the
    host, so it includes the device's work).
    """

    def __init__(self, sched: DiffusionSchedule, calib, *,
                 min_kid: float = 0.0,
                 samplers: Optional[Dict[str, Sampler]] = None,
                 server_fn=None, cond_server_fn=None, feat_params=None,
                 noise: Optional[NoiseSource] = None,
                 backend: BackendLike = None):
        self.sched = sched
        self.calib = torch.as_tensor(calib, dtype=torch.float32)
        if self.calib.ndim != 4:
            raise ValueError(f"calibration batch must be (N, H, W, C), got "
                             f"{tuple(self.calib.shape)}")
        if self.calib.shape[0] < 2:
            raise ValueError(
                f"calibration batch of {self.calib.shape[0]} image(s): the "
                "unbiased KID estimator needs >= 2 "
                "(privacy.kid_from_features)")
        self.min_kid = float(min_kid)
        self.samplers = dict(samplers) if samplers is not None else None
        self.server_fn = server_fn
        self.cond_server_fn = cond_server_fn
        self.params_version = 0                   # bumped on weight swaps
        self.feat_params = (feat_params if feat_params is not None else
                            privacy.feature_params(in_ch=self.calib.shape[-1]))
        self.noise = noise
        self.backend = backend
        self._calib_feats = None                  # computed once
        self._kid_cache: Dict[tuple, float] = {}
        # (sampler, w) -> (position, x there, step-noise function): the
        # deepest point each calibration chain reached
        self._chains: Dict[tuple, tuple] = {}
        self._decision_cache: Dict[tuple, AdmissionDecision] = {}
        self.model_calls = 0
        self.cache_hits = 0
        self.score_s = 0.0
        # the engine attaches its tracer, so cache FILLS (the model work,
        # not the cache hits) show as spans on the serve timeline
        self.tracer = NULL_TRACER

    # ------------------------------------------------------------------
    def _same_outputs(self, a, b, *args) -> bool:
        """Spot-check two server models on a calibration image at t = T."""
        x = self.calib[:1]
        t = torch.full((1,), self.sched.T, dtype=torch.int64,
                       device=x.device)
        with torch.inference_mode():
            return bool(torch.allclose(a(x, t, *args), b(x, t, *args),
                                       rtol=1e-5, atol=1e-6))

    def bind(self, *, server_fn=None, samplers=None,
             cond_server_fn=None) -> None:
        """Late-bind the pieces the engine owns; pieces already set must
        agree with the engine's.  A server model that disagrees with the
        bound one on a calibration image at t = T is a WEIGHT SWAP: the
        policy adopts it, bumps ``params_version`` and clears every cached
        score and decision in place (clones from :meth:`with_min_kid` see
        it too)."""
        if server_fn is not None:
            if self.server_fn is None:
                self.server_fn = server_fn
            elif not self._same_outputs(self.server_fn, server_fn):
                self.server_fn = server_fn
                self._bump_params_version()
        if cond_server_fn is not None:
            if self.cond_server_fn is None:
                self.cond_server_fn = cond_server_fn
                # guided scores cached so far ran ε̂_c = ε̂_u (no conditional
                # model): right only at w = 0, so score them again
                if any(ck[2] is not None for ck in self._kid_cache):
                    self._bump_params_version()
            else:
                y = torch.zeros((1,), dtype=torch.int64,
                                device=self.calib.device)
                if not self._same_outputs(self.cond_server_fn,
                                          cond_server_fn, y):
                    self.cond_server_fn = cond_server_fn
                    self._bump_params_version()
        if samplers is not None:
            if self.samplers is None:
                self.samplers = dict(samplers)
            else:
                assert_same_menu(self.samplers, samplers,
                                 "admission policy", "engine")

    def _bump_params_version(self) -> None:
        """Invalidate everything scored under the previous weights, in place
        (the score cache and chains are shared with clones)."""
        self.params_version += 1
        self._kid_cache.clear()
        self._chains.clear()
        self._decision_cache.clear()

    def register_sampler(self, name: str, sampler: Sampler) -> None:
        """Add (or replace) one menu entry; its cached scores, chain and
        decisions go, in place."""
        if self.samplers is None:
            self.samplers = {}
        self.samplers[name] = sampler
        self._invalidate(name)

    def unregister_sampler(self, name: str) -> None:
        """Drop one menu entry with its cached scores and decisions."""
        if self.samplers is not None:
            self.samplers.pop(name, None)
        self._invalidate(name)

    def _invalidate(self, name: str) -> None:
        # mutate, never rebind: the caches are shared with with_min_kid
        # clones (scores are floor-independent)
        for cache in (self._kid_cache, self._chains, self._decision_cache):
            for ck in [ck for ck in cache if ck[0] == name]:
                del cache[ck]

    def with_min_kid(self, min_kid: float) -> "AdmissionPolicy":
        """A policy at another floor SHARING this one's scores and chains
        (only decisions are derived again)."""
        p = AdmissionPolicy(self.sched, self.calib, min_kid=min_kid,
                            samplers=self.samplers, server_fn=self.server_fn,
                            cond_server_fn=self.cond_server_fn,
                            feat_params=self.feat_params, noise=self.noise,
                            backend=self.backend)
        p._calib_feats = self._calib_feats
        p._kid_cache = self._kid_cache            # shared, floor-independent
        p._chains = self._chains
        p.params_version = self.params_version
        p.tracer = self.tracer
        return p

    def release_chains(self) -> None:
        """Free the x each calibration chain holds; the scores stay, and a
        deeper position later starts its chain again from x_T."""
        self._chains.clear()

    # ------------------------------------------------------------------
    # scoring: one chain per (sampler, w), every position cached
    # ------------------------------------------------------------------
    def _score_key(self, name: str, pos: int) -> tuple:
        smp = (self.samplers or {}).get(name)
        return (name, int(pos), smp.w if smp is not None and smp.guided
                else None)

    def _kid_of(self, x) -> float:
        feats = privacy.extract_features(self.feat_params, x)
        return float(privacy.kid_from_features(self._calib_feats, feats))

    def disclosure_kid(self, sampler_name: str, pos: int) -> float:
        """Disclosure KID of x at trajectory position ``pos`` under
        ``sampler_name`` on the calibration batch (cached per (sampler,
        position, w); a miss extends the sampler's chain to ``pos``,
        scoring every position on the way)."""
        ck = self._score_key(sampler_name, pos)
        if ck in self._kid_cache:
            self.cache_hits += 1
            return self._kid_cache[ck]
        if self.samplers is None or sampler_name not in self.samplers:
            raise KeyError(f"unknown sampler {sampler_name!r}; policy menu: "
                           f"{sorted(self.samplers or {})}")
        if self.server_fn is None:
            raise RuntimeError(
                "AdmissionPolicy.server_fn unbound: pass server_fn= or hand "
                "the policy to ServeEngine(admission=...), which binds its "
                "own server model")
        smp = self.samplers[sampler_name]
        assert 0 <= pos <= smp.K, (pos, smp.K)
        t0 = time.perf_counter()
        with self.tracer.span("admission_score", cat="admission",
                              sampler=sampler_name, pos=int(pos)), \
                torch.inference_mode():
            self._extend_chain(sampler_name, smp, ck[2], int(pos))
        self.score_s += time.perf_counter() - t0   # each score syncs
        return self._kid_cache[ck]

    def _extend_chain(self, name: str, smp: Sampler, w_key, pos: int):
        if self._calib_feats is None:
            self._calib_feats = privacy.extract_features(self.feat_params,
                                                         self.calib)
        # a cached position implies every earlier one is cached, so a
        # miss at pos lies beyond the chain's end (or the chain was freed)
        chain = self._chains.get((name, w_key))
        if chain is None:
            x, server_noise = disclosure_start(self.sched, CALIB_SEED,
                                               self.calib, self.noise)
            chain = (0, x, server_noise)
            self._kid_cache[(name, 0, w_key)] = self._kid_of(x)
        at, x, server_noise = chain
        # scored on the guided trajectory for guided samplers; the label
        # does not enter the score (one label-0 chain per (sampler, w))
        cond = (self.cond_server_fn if smp.guided and smp.w != 0.0
                else None)
        calls = 2 if smp.guided and smp.w != 0.0 else 1
        while at < pos:
            x = sample_trajectory(self.sched, smp, self.server_fn,
                                  server_noise, x, at, at + 1,
                                  backend=self.backend, cond_fn=cond,
                                  label=0)
            at += 1
            self.model_calls += calls
            self._kid_cache[(name, at, w_key)] = self._kid_of(x)
        self._chains[(name, w_key)] = (at, x, server_noise)

    def profile(self, sampler_name: str,
                max_pos: Optional[int] = None) -> List[float]:
        """Disclosure KID at every position 0..max_pos (default K): the
        landscape the gate scans.  One chain; its x is freed after."""
        smp = self.samplers[sampler_name]
        hi = smp.K if max_pos is None else max_pos
        self.disclosure_kid(sampler_name, hi)    # fills every p <= hi
        w_key = self._score_key(sampler_name, 0)[2]
        self._chains.pop((sampler_name, w_key), None)
        return [self._kid_cache[(sampler_name, p, w_key)]
                for p in range(hi + 1)]

    # ------------------------------------------------------------------
    # decisions, cached per (sampler, cut_ratio)
    # ------------------------------------------------------------------
    def decide(self, req) -> AdmissionDecision:
        """Gate one :class:`~repro_torch.serve.scheduler.Request`
        (deterministic, cached per (sampler, cut_ratio))."""
        base = self._decide(req.sampler, req.cut_ratio)
        return dataclasses.replace(base, req_id=req.req_id)

    def _decide(self, name: str, cut_ratio: float) -> AdmissionDecision:
        ck = (name, float(cut_ratio))
        if ck in self._decision_cache:
            return self._decision_cache[ck]
        if self.samplers is None or name not in self.samplers:
            raise KeyError(f"unknown sampler {name!r}; policy menu: "
                           f"{sorted(self.samplers or {})}")
        smp = self.samplers[name]
        nominal = CutPlan(self.sched.T, cut_ratio).cut_index(smp)
        mk = functools.partial(
            AdmissionDecision, req_id=-1, sampler=name,
            cut_ratio=float(cut_ratio), nominal_cut=nominal,
            min_kid=self.min_kid)
        best = float("-inf")
        d = None
        # scan toward NOISIER disclosure: position p serves [0, p), so a
        # smaller p discloses x earlier in the chain
        for pos in range(nominal, -1, -1):
            k = self.disclosure_kid(name, pos)
            best = max(best, k)
            if k >= self.min_kid:
                d = mk(effective_cut=pos, kid=k,
                       action=ADMIT if pos == nominal else BUMP)
                break
        if d is None:
            d = mk(effective_cut=-1, kid=best, action=REJECT)
        self._decision_cache[ck] = d
        return d

    def describe(self) -> str:
        menu = sorted(self.samplers) if self.samplers else "<unbound>"
        return (f"AdmissionPolicy(min_kid={self.min_kid:g}, "
                f"calib={self.calib.shape[0]} imgs, menu={menu})")
