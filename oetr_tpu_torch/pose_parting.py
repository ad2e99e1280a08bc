"""Where estimate_pose on the card and on the CPU part, on the same inputs
and the same draws.

On the card the null vectors and 3x3 SVDs come from the Jacobi kernel
(``ops.eigh``, ``svd3_from_eigh``), on the CPU from LAPACK; products sum in
another order. Either can move a hypothesis's MSAC score, the choice of the
LO candidates, a Gauss-Newton accept (``s_new >= s_old``) or the final
vote. This runs estimate_pose on the card with its draws recorded, then on
the CPU on those draws twice: as it is, and with every eigh and svd3 result
replaced by the card's (so that only the rest of the arithmetic differs).
Each run records what each stage hands the next; a line per problem
gives each run's errors and inliers and, for each pair, the first stage
where the CPU run parts from the card's; the last line the largest gaps:

  round1, five_point, round2  the best hypothesis of the round (MSAC)
  lo_candidates               the LO candidates (the scores' top 8)
  lo_start                    the candidates' inliers after the LO refits
  e_refine                    the E route's Gauss-Newton result
  e_route                     ransac_essential's inliers
  homography                  ransac_homography's inliers
  pp_start, pp_refine         the plane-and-parallax candidates, refined
  vote                        the winning slot of the planar vote
  final                       the inliers

For each refinement it also runs Gauss-Newton from the card's start on both
devices, one step more each time, and gives the first step whose accept
differs (``gn_flips``: [candidate, step]). It runs them in float64: the
float32 refinement returns its input, as JAX's does, so in the estimator's
float32 the refinement stages part only where their starts do.

    python -m oetr_tpu_torch.pose_parting [--problems 5] [--pairs 3]
        [--true 200] [--slots 256]

``--spread`` needs no card: it measures the float32 estimator's own spread
on the CPU, where only the eigensolvers' rounding changes. The same
problems and draws run twice: with LAPACK's float32 routines (ssyevd,
sgesdd: the CPU path, JAX's bits) and with its float64 ones (dsyevd,
dgesdd) on the float64 copy of each input, rounded back to float32. A line
per problem gives each pair's gap (|Δerr_R|, |Δerr_t| in degrees, the
inlier counts' relative gap); the last line counts the cases (a problem, 5-point
stage off or on) whose largest gap is beyond 0.25° or 1%, the bound that
held the card to the CPU while the float32 refinement moved. At
``chip_smoke.py``'s pose size:

    python -m oetr_tpu_torch.pose_parting --spread --problems 8 --pairs 8
        --true 1400 --slots 2048
"""
from __future__ import annotations

import argparse
import contextlib
import json

import torch

from .geometry import draws, homography, ransac
from .geometry.epipolar import pose_error
from .profile_forward import general_pose_pairs

STAGES = ("round1", "five_point", "round2", "lo_candidates", "lo_start",
          "e_refine", "e_route", "homography", "pp_start", "pp_refine",
          "vote", "final")
HOOKED = ("_msac_counts", "five_point_hypotheses", "recover_pose",
          "refine_pose_sampson", "ransac_essential", "ransac_homography",
          "_vote", "eigh", "svd3")


@contextlib.contextmanager
def recorded(replay=None):
    """Records the inputs and outputs of the estimator's stages (HOOKED)
    in call order; with ``replay`` (an earlier record), eigh and svd3
    return that record's results, on this run's device, instead."""
    log = {name: [] for name in HOOKED}
    real = {name: getattr(ransac, name) for name in HOOKED}
    real_h_eigh = homography.eigh

    def hook(name):
        def fn(*args, **kwargs):
            if replay is not None and name in ("eigh", "svd3"):
                k = len(log[name])
                out = tuple(x.to(args[0].device) for x in replay[name][k][1])
                if out[-1].shape[:-2] != args[0].shape[:-2]:
                    raise AssertionError(f"{name} call {k}: another shape")
            else:
                out = real[name](*args, **kwargs)
            log[name].append((args, out))
            return out
        return fn

    for name in HOOKED:
        setattr(ransac, name, hook(name))
    homography.eigh = ransac.eigh
    try:
        yield log
    finally:
        for name in HOOKED:
            setattr(ransac, name, real[name])
        homography.eigh = real_h_eigh


@contextlib.contextmanager
def wide_lapack():
    """The estimator's eigh and svd3 from LAPACK's float64 routines on the
    float64 copy of each input, rounded back to the input's dtype: the same
    functions, another rounding (CPU tensors)."""
    from .ops import small_eigh

    def eigh(A):
        return tuple(x.to(A.dtype) for x in small_eigh.eigh(A.double()))

    def svd3(A):
        return tuple(x.to(A.dtype) for x in small_eigh.svd3(A.double()))

    real = ransac.eigh, ransac.svd3, homography.eigh
    ransac.eigh = homography.eigh = eigh
    ransac.svd3 = svd3
    try:
        yield
    finally:
        ransac.eigh, ransac.svd3, homography.eigh = real


def parting(T, a, b):
    """Per pair, how far result a lies from result b (estimate_pose's, on
    the problems' truth T): max(|Δerr_R|, |Δerr_t|) in degrees, and
    |Δnum_inliers| relative to b's; CPU tensors."""
    (et_a, eR_a), (et_b, eR_b) = (pose_error(T, r["R"].cpu(), r["t"].cpu())
                                  for r in (a, b))
    n_a, n_b = a["num_inliers"].cpu(), b["num_inliers"].cpu()
    return (torch.maximum((eR_a - eR_b).abs(), (et_a - et_b).abs()),
            (n_a - n_b).abs().float() / n_b.clamp(min=1).float())


def spread(args) -> int:
    """``--spread``: the float32 estimator on the CPU with LAPACK's float32
    routines against its float64 ones (``wide_lapack``), on the same
    problems and draws."""
    cases = beyond = 0
    worst = {"deg": 0.0, "inliers_rel": 0.0}
    for problem in range(args.problems):
        d = general_pose_pairs(args.pairs,
                               torch.Generator().manual_seed(43 + problem),
                               n_true=args.true, n_slots=args.slots)
        for use_5pt in (False, True):
            plain, _, drawn = run(d, "cpu", use_5pt, 46)
            with wide_lapack():
                wide, _, _ = run(d, "cpu", use_5pt, 46, drawn)
            deg, rel = parting(d["T_0to1"], wide, plain)
            cases += 1
            beyond += bool(deg.max() > 0.25 or rel.max() > 0.01)
            worst["deg"] = max(worst["deg"], deg.max().item())
            worst["inliers_rel"] = max(worst["inliers_rel"], rel.max().item())
            print(json.dumps({"problem": 43 + problem, "use_5pt": use_5pt,
                              "inliers": plain["num_inliers"].tolist(),
                              "wide_inliers": wide["num_inliers"].tolist(),
                              "gap_deg": deg.tolist(),
                              "inliers_rel": rel.tolist()}), flush=True)
    print(json.dumps({"spread": {"cases": cases,
                                 "beyond_0.25deg_or_1pct": beyond,
                                 "worst": worst}}), flush=True)
    return 0


def run(d, device, use_5pt, seed, replay_draws=None, replay=None):
    """estimate_pose on ``device``, its stages recorded; its draws from a
    generator seeded ``seed`` or ``replay_draws``. Returns (result, record,
    the draws)."""
    d = {k: v.to(device) for k, v in d.items()}
    real, drawn = draws.gumbel, {}

    def gumbel(stage, shape, generator):
        if replay_draws is None:
            drawn[stage] = real(stage, shape, generator)
        else:
            drawn[stage] = replay_draws[stage].to(device)
        return drawn[stage]

    draws.gumbel = gumbel
    try:
        with recorded(replay) as log:
            res = ransac.estimate_pose(
                d["kpts0"], d["kpts1"], d["valid"], d["K"], d["K"],
                torch.Generator(device=device).manual_seed(seed),
                use_5pt=use_5pt)
    finally:
        draws.gumbel = real
    return res, log, drawn


def stage_values(log, use_5pt):
    """The value each stage hands on, per pair (leading dim), on the CPU."""
    cpu = lambda x: x.detach().cpu()
    counts = [cpu(out) for _, out in log["_msac_counts"]]
    rounds = ["round1"] + (["five_point"] if use_5pt else []) + ["round2"]
    if use_5pt:   # invalid 5-point solutions score -1, as in the estimator
        _, (_, ok5) = log["five_point_hypotheses"][0]
        counts[1] = torch.where(cpu(ok5), counts[1], -1.0)
    vals = {name: c.argmax(-1) for name, c in zip(rounds, counts)}
    allc = torch.cat(counts, -1)
    vals["lo_candidates"] = torch.sort(allc, dim=-1, descending=True,
                                       stable=True).indices[..., :8]
    (_, _, _, inl_lo), _ = log["recover_pose"][0]
    vals["lo_start"] = cpu(inl_lo)
    _, (R_e, t_e) = log["refine_pose_sampson"][0]
    vals["e_refine"] = (cpu(R_e), cpu(t_e))
    vals["e_route"] = cpu(log["ransac_essential"][0][1]["inliers"])
    vals["homography"] = cpu(log["ransac_homography"][0][1]["inliers"])
    (_, _, _, inl_pp), _ = log["recover_pose"][1]
    vals["pp_start"] = cpu(inl_pp)
    _, (R_p, t_p) = log["refine_pose_sampson"][1]
    vals["pp_refine"] = (cpu(R_p), cpu(t_p))
    vals["vote"] = cpu(log["_vote"][0][1])
    return vals


def same(a, b, pair):
    """Whether stage values a and b agree on ``pair``: masks and indices
    equal, rotations and translations within 1e-5."""
    if isinstance(a, tuple):
        return all(bool(((x[pair] - y[pair]).abs() <= 1e-5).all())
                   for x, y in zip(a, b))
    return bool(torch.equal(a[pair], b[pair]))


def gn_flips(card_log, k):
    """Gauss-Newton in float64 from the card's start of refinement ``k``
    on the card and on the CPU, 1 to 15 steps: per pair, the first
    (candidate, step) whose accept (R moved) differs, or None."""
    wide = lambda a: (a.double() if torch.is_tensor(a)
                      and a.is_floating_point() else a)
    args = tuple(wide(a) for a in card_log["refine_pose_sampson"][k][0])
    cpu_args = tuple(a.cpu() if torch.is_tensor(a) else a for a in args)
    prev = {"card": args[0], "cpu": cpu_args[0]}
    flips = [None] * args[0].shape[0]
    for step in range(1, 16):
        moved = {}
        for name, a in (("card", args), ("cpu", cpu_args)):
            R, _ = ransac.refine_pose_sampson(*a, iters=step)
            moved[name] = (R != prev[name]).flatten(-2).any(-1).cpu()
            prev[name] = R
        diff = moved["card"] != moved["cpu"]
        for pair in range(len(flips)):
            c = torch.nonzero(diff[pair]).flatten()
            if flips[pair] is None and len(c):
                flips[pair] = [int(c[0]), step]
    return flips


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--problems", type=int, default=5)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--true", type=int, default=200)
    ap.add_argument("--slots", type=int, default=256)
    ap.add_argument("--spread", action="store_true",
                    help="the float32 estimator's own spread, on the CPU")
    args = ap.parse_args(argv)
    if args.spread:
        return spread(args)
    if not torch.cuda.is_available():
        raise SystemExit("pose_parting: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    worst = {name: {"deg": 0.0, "inliers_rel": 0.0}
             for name in ("cpu", "cpu_card_linalg")}
    errors = lambda res: [e.cpu() for e in pose_error(
        d["T_0to1"], res["R"].cpu(), res["t"].cpu())]
    for problem in range(args.problems):
        d = general_pose_pairs(args.pairs,
                               torch.Generator().manual_seed(43 + problem),
                               n_true=args.true, n_slots=args.slots)
        for use_5pt in (False, True):
            card, card_log, drawn = run(d, "cuda", use_5pt, 46)
            want = stage_values(card_log, use_5pt)
            want["final"] = card["inliers"].cpu()
            et_g, eR_g = errors(card)
            n_g = card["num_inliers"].cpu()
            line = {"problem": 43 + problem, "use_5pt": use_5pt,
                    "card_inliers": n_g.tolist(),
                    "card_err_R_deg": eR_g.tolist(),
                    "card_err_t_deg": et_g.tolist()}
            for name, replay in (("cpu", None), ("cpu_card_linalg",
                                                 card_log)):
                res, log, _ = run(d, "cpu", use_5pt, 46, drawn, replay)
                got = stage_values(log, use_5pt)
                got["final"] = res["inliers"]
                parted = []
                for pair in range(args.pairs):
                    first = next((s for s in STAGES if s in want
                                  and not same(want[s], got[s], pair)), None)
                    parted.append(first)
                et, eR = errors(res)
                deg, rel = parting(d["T_0to1"], card, res)
                gap, rel = deg.max().item(), rel.max().item()
                n = res["num_inliers"]
                worst[name]["deg"] = max(worst[name]["deg"], gap)
                worst[name]["inliers_rel"] = max(worst[name]["inliers_rel"],
                                                 rel)
                line[name] = {"inliers": n.tolist(), "err_R_deg": eR.tolist(),
                              "err_t_deg": et.tolist(),
                              "gap_to_card_deg": gap,
                              "first_parting": parted}
            line["gn_flips"] = {"e_refine": gn_flips(card_log, 0),
                                "pp_refine": gn_flips(card_log, 1)}
            print(json.dumps(line), flush=True)
    print(json.dumps({"worst_gap_to_card": worst}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
