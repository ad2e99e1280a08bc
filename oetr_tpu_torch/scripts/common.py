"""What the demo programs share: the log, the cv2 check, grayscale copies of
a dataset item, the SIFT + NN row, the pose-AUC row with its bootstrap
spread, per-step generators, the matching trainers' optimiser, state files
that survive a kill and the segments that re-execute a program."""
from __future__ import annotations

import hashlib
import os
import sys

import numpy as np
import torch

from ..evalx.metrics import pose_auc
from ..evalx.twoview import validation_error
from ..models.matchers import nearest_neighbor_match
from ..models.sift_based import sift_keypoints
from ..training.optim import piecewise_constant_schedule
from ..training.train import StepScheduler

LUM = (0.299, 0.587, 0.114)


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def require_cv2(flag: str) -> None:
    """Raise ImportError naming cv2 and ``flag`` where cv2 is missing."""
    try:
        import cv2  # noqa: F401
    except ImportError as e:
        raise ImportError(f"{flag} needs cv2 (OpenCV), which is not "
                          "installed here") from e


def gray_of(item: dict, key: str) -> np.ndarray:
    """An item's RGB image [h, w, 3] in [0, 1] as gray [h, w, 1] float32."""
    return np.dot(item[key][..., :3], list(LUM)).astype(np.float32)[..., None]


def gray_u8(image: np.ndarray) -> np.ndarray:
    """cv2's 8-bit gray of an RGB image in [0, 1] (SIFT's input)."""
    import cv2

    return cv2.cvtColor((image * 255).astype(np.uint8), cv2.COLOR_RGB2GRAY)


def nn_matches0(d0, d1, v0, v1, ratio: float, device) -> np.ndarray:
    """matches0 [K] of the mutual NN matcher with the ratio test, one pair
    of numpy descriptors [K, D] and validity [K]."""
    t = lambda a: torch.as_tensor(np.asarray(a), device=device)[None]
    m = nearest_neighbor_match(t(d0), t(d1), t(v0), t(v1),
                               ratio_threshold=ratio)
    return m["matches0"][0].cpu().numpy()


def index_pairs(m0: np.ndarray, sel: np.ndarray) -> np.ndarray:
    """[2, M] index pairs of the selected slots of matches0."""
    return np.stack([np.nonzero(sel)[0], m0[sel]])


def sift_nn(image0: np.ndarray, image1: np.ndarray, topk: int, ratio: float,
            device):
    """SIFT keypoints of two RGB images, RootSIFT, mutual NN with the ratio
    test: (xy0, xy1, [2, M] matches)."""
    xy0, _, v0, d0 = sift_keypoints(gray_u8(image0), topk,
                                    with_descriptors=True)
    xy1, _, v1, d1 = sift_keypoints(gray_u8(image1), topk,
                                    with_descriptors=True)
    m0 = nn_matches0(d0, d1, v0, v1, ratio, device)
    return xy0, xy1, index_pairs(m0, m0 > -1)


# A dataset item's keys, from the device generator's batch keys.
ITEM_KEYS = {"image1": "image1", "image2": "image2", "depth1": "depth1",
             "depth2": "depth2", "intrinsics1": "K1", "intrinsics2": "K2",
             "pose1": "pose1", "pose2": "pose2",
             "overlap_box1": "overlap_box1", "overlap_box2": "overlap_box2",
             "overlap_valid": "overlap_valid"}


def items_of(raw: dict) -> list:
    """A batch of ``data/device_synth.make_device_generator`` as a list of
    ``MegaDepthPairsDataset`` items (numpy), what the programs' evaluate
    functions take."""
    arrays = {k: raw[src].detach().cpu().numpy()
              for k, src in ITEM_KEYS.items()}
    return [{k: v[i] for k, v in arrays.items()}
            for i in range(len(arrays["image1"]))]


def relative_pose(item: dict) -> np.ndarray:
    return item["pose2"] @ np.linalg.inv(item["pose1"])


def pose_errors(items: list, run_pair, device) -> dict:
    """``run_pair(i, item) -> (xy0, xy1, matches)`` scored on every item by
    ``validation_error`` (its draws from rng_seed 0): the lists of
    max(err_t, err_R), precision, matching score and match count."""
    out = {"errors": [], "precision": [], "matching_score": [], "n": []}
    for pi, it in enumerate(items):
        xy0, xy1, matches = run_pair(pi, it)
        out["n"].append(matches.shape[1])
        res = validation_error(xy0, xy1, matches, it["intrinsics1"],
                               it["intrinsics2"], relative_pose(it),
                               device=device)
        out["errors"].append(max(res["error_t"], res["error_R"]))
        out["precision"].append(res["precision"])
        out["matching_score"].append(res["matching_score"])
    return out


def auc_row(scored: dict) -> dict:
    """The demos' pose row: AUC@5/10/20, AUC@5's spread over 200 bootstrap
    resamples of the pairs (numpy seed 7), mean precision and matches."""
    errors = scored["errors"]
    aucs = pose_auc(errors, [5, 10, 20])
    bs = np.random.default_rng(7)
    errs = np.asarray(errors)
    sig = float(np.std([pose_auc(errs[bs.integers(0, len(errs), len(errs))],
                                 [5])[0] for _ in range(200)]))
    return {"auc@5": round(float(aucs[0]), 4),
            "auc@5_sigma": round(sig, 4),
            "auc@10": round(float(aucs[1]), 4),
            "auc@20": round(float(aucs[2]), 4),
            "precision": round(float(np.mean(scored["precision"])), 4),
            "matches_per_pair": round(float(np.mean(scored["n"])), 1)}


def step_seed(base: int, it: int) -> int:
    """A seed for step ``it`` of the stream ``base``: a function of both,
    as JAX's ``fold_in(key(base), it)`` is, so a resumed run draws what
    the uninterrupted one drew."""
    digest = hashlib.sha256(f"{base}:{it}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def step_generator(base: int, it: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(step_seed(base, it))


def save_state(path: str, **state) -> None:
    """``torch.save(state)`` to ``path`` so that a kill at any point leaves
    either the old or the new file: save to ``path.new``, move the old one
    to ``path.old``, rename, then drop ``path.old``."""
    new, old = path + ".new", path + ".old"
    torch.save(state, new)
    if os.path.exists(old):
        os.remove(old)
    if os.path.exists(path):
        os.rename(path, old)
    os.rename(new, path)
    if os.path.exists(old):
        os.remove(old)


def load_state(path: str) -> dict | None:
    """The state ``save_state`` wrote at ``path`` (recovered from
    ``path.old`` after a kill between its renames), or None."""
    if not os.path.exists(path) and os.path.exists(path + ".old"):
        log(f"recovering {os.path.basename(path)} from .old")
        os.rename(path + ".old", path)
    if not os.path.exists(path):
        return None
    return torch.load(path, map_location="cpu", weights_only=True)


def reexec(module: str, argv: list[str]) -> None:
    """Replace this process by ``python -m module argv``."""
    sys.stdout.flush()
    sys.stderr.flush()
    os.execv(sys.executable, [sys.executable, "-m", module, *argv])


def adam(model, lr: float, steps: int):
    """(Adam, its StepScheduler at ``lr``, x0.1 from 70% of ``steps``): the
    matching demos' optax chain with the clip passed to the step."""
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    return opt, StepScheduler(opt, piecewise_constant_schedule(
        lr, {int(steps * 0.7): 0.1}))


def restore(path: str | None, model, opt, sched) -> int:
    """Load a segment state into the model, optimizer and schedule; the
    step it was saved at (0 where there is none)."""
    state = load_state(path) if path else None
    if state is None:
        return 0
    log(f"restoring segment state {os.path.basename(path)}")
    model.load_state_dict(state["model"])
    opt.load_state_dict(state["optimizer"])
    sched.load_state_dict(state["scheduler"])
    return int(state["step"])


def saver(path: str | None, model, opt, sched):
    """``save(step)``: the segment state to ``path`` (no-op without one)."""
    def save(step: int) -> None:
        if path:
            save_state(path, step=step, model=model.state_dict(),
                       optimizer=opt.state_dict(),
                       scheduler=sched.state_dict())
    return save


class Segments:
    """Counts optimizer steps in this process; once ``limit`` are spent,
    saves the phase's state and re-executes ``module`` (0: never). A phase
    ticks every ``every`` steps (``min(100, limit)`` by default)."""

    def __init__(self, limit: int, argv: list[str], module: str,
                 every: int | None = None):
        self.limit, self.argv, self.module, self.done = limit, argv, module, 0
        self.every = every or (max(1, min(100, limit)) if limit else 100)

    def due(self, it: int, stop: int) -> bool:
        """Whether step ``it`` (done) ends a tick before the last step."""
        return (it + 1) % self.every == 0 and (it + 1) < stop

    def tick(self, save) -> None:
        self.done += self.every
        if self.limit and self.done >= self.limit:
            save()
            log(f"segment limit {self.limit} reached; re-exec")
            reexec(self.module, self.argv)
