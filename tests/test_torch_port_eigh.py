"""The eigh kernel's algorithm, on the CPU: its plain twin
``ops.small_eigh.eigh_jacobi_reference`` (the kernel's round-robin parallel
Jacobi, stopping rule and sort, in torch) against LAPACK's syevd (the
port's CPU ``eigh``) and against ``jnp.linalg.eigh`` in float32.

The kernel itself (``csrc/small_eigh.cu``) runs only on the card, where
``tests/test_torch_port_gpu.py`` holds it to LAPACK and to this twin.

Bounds (EIGH_TOL, relative to each matrix's largest |eigenvalue|, as the
pose phase of ``chip_smoke.py`` holds the kernel): eigenvalues against the
reference, the residual |A V - V diag(w)| and V's orthogonality; all three
are backward stable to ~n float32 ulps. Null vectors of nearly singular
normal matrices: |v · v_ref| > 1 - 1e-4 where the relative gap to the next
eigenvalue is over 1e-3 (``test_eigh_kernel_matches_lapack``'s check), and
on every matrix |v - v_ref| times that gap within EIGH_TOL (a null vector
moves by the backward error over the gap).
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oetr_tpu_torch.ops import _build, small_eigh

torch.set_num_threads(2)

EIGH_TOL = 1e-5
DOT_TOL = 1e-4
GAP = 1e-3


def _jax_eigh(A: np.ndarray):
    w, V = jax.jit(jax.vmap(jnp.linalg.eigh))(jnp.asarray(A, jnp.float32))
    return np.array(w), np.array(V)


def _check(A: np.ndarray, w: torch.Tensor, V: torch.Tensor):
    """The twin's (w, V) against LAPACK's and JAX's eigenvalues, with its
    residual, orthogonality and order."""
    n = A.shape[-1]
    A64 = torch.from_numpy(A).double()
    w_ref = small_eigh.eigh_reference(torch.from_numpy(A))[0].double()
    w_jax = torch.from_numpy(_jax_eigh(A)[0]).double()
    w64, V64 = w.double(), V.double()
    scale = w_ref.abs().amax(-1, keepdim=True).clamp(min=1e-30)
    for ref in (w_ref, w_jax):
        assert ((w64 - ref).abs() / scale).max() < EIGH_TOL
    res = (A64 @ V64 - V64 * w64[..., None, :]).abs().amax(-1) / scale
    assert res.max() < EIGH_TOL
    eye = torch.eye(n, dtype=torch.float64)
    assert (V64.transpose(-1, -2) @ V64 - eye).abs().max() < EIGH_TOL
    assert (w64[..., 1:] >= w64[..., :-1]).all()


def _null_vectors(A: np.ndarray, V: torch.Tensor):
    """The twin's null vector against LAPACK's and JAX's: |v · v_ref| >
    1 - DOT_TOL where the relative gap to the next eigenvalue is over GAP,
    and everywhere |v - v_ref| · gap <= EIGH_TOL (a null vector moves by
    ~n ulps of |A| over the gap). Returns how many had a clear gap."""
    w_ref, V_ref = small_eigh.eigh_reference(torch.from_numpy(A))
    gap = ((w_ref[:, 1] - w_ref[:, 0]) / w_ref[:, -1]).double()
    held = gap > GAP
    v = V[:, :, 0].double()
    for ref in (V_ref, torch.from_numpy(_jax_eigh(A)[1])):
        r = ref[:, :, 0].double()
        dot = (v * r).sum(-1)
        assert (dot.abs()[held] > 1 - DOT_TOL).all()
        moved = (v - torch.sign(dot)[:, None] * r).norm(dim=-1)
        assert (moved * gap).max() <= EIGH_TOL
    return int(held.sum())


def _random_normal(rng, b, rows):
    """AᵀA of 8-point rows of uniform random coordinates in [-0.6, 0.6]
    (``tests/test_torch_port_gpu.py``'s ``_normal_matrices``)."""
    x = rng.uniform(-0.6, 0.6, (b, rows, 4)).astype(np.float32)
    a = np.stack([x[..., 2] * x[..., 0], x[..., 2] * x[..., 1], x[..., 2],
                  x[..., 3] * x[..., 0], x[..., 3] * x[..., 1], x[..., 3],
                  x[..., 0], x[..., 1], np.ones_like(x[..., 0])], -1)
    return a.transpose(0, 2, 1) @ a


def _eight_point_normal(rng, b, rows):
    """AᵀA of 8-point constraint rows [x1 x0, x1 y0, x1, y1 x0, y1 y0, y1,
    x0, y0, 1] of noisy correspondences under a random pose, as the pose
    path builds them."""
    x0 = rng.uniform(-0.6, 0.6, (b, rows, 2))
    R = np.linalg.qr(rng.normal(size=(b, 3, 3)))[0]
    t = rng.normal(size=(b, 3))
    X = np.concatenate([x0, np.ones((b, rows, 1))], -1) * rng.uniform(
        2, 8, (b, rows, 1))
    Y = X @ R.transpose(0, 2, 1) + t[:, None]
    x1 = Y[..., :2] / Y[..., 2:] + rng.normal(scale=1e-3, size=(b, rows, 2))
    a = np.stack([x1[..., 0] * x0[..., 0], x1[..., 0] * x0[..., 1],
                  x1[..., 0], x1[..., 1] * x0[..., 0],
                  x1[..., 1] * x0[..., 1], x1[..., 1], x0[..., 0],
                  x0[..., 1], np.ones_like(x0[..., 0])], -1)
    a = a.astype(np.float32)
    return a.transpose(0, 2, 1) @ a


def _dlt_normal(rng, b, points):
    """AᵀA of the DLT rows of a homography's noisy correspondences (two
    rows a point), as ``geometry/homography.py`` builds them."""
    p0 = rng.uniform(-1, 1, (b, points, 2))
    H = np.eye(3) + rng.normal(scale=0.2, size=(b, 3, 3))
    q = np.concatenate([p0, np.ones((b, points, 1))], -1) @ H.transpose(
        0, 2, 1)
    p1 = q[..., :2] / q[..., 2:] + rng.normal(scale=1e-3, size=(b, points, 2))
    x, y = p0[..., 0], p0[..., 1]
    u, v = p1[..., 0], p1[..., 1]
    one, zero = np.ones_like(x), np.zeros_like(x)
    r1 = np.stack([-x, -y, -one, zero, zero, zero, u * x, u * y, u], -1)
    r2 = np.stack([zero, zero, zero, -x, -y, -one, v * x, v * y, v], -1)
    a = np.concatenate([r1, r2], 1).astype(np.float32)
    return a.transpose(0, 2, 1) @ a


@pytest.mark.parametrize("n", range(1, 17))
def test_jacobi_rounds_visit_every_pair_once(n):
    """Each round pairs disjoint indices; a sweep visits each of the
    n (n - 1) / 2 pairs exactly once, in m - 1 rounds (m = n + n % 2)."""
    rounds = small_eigh.jacobi_rounds(n)
    assert len(rounds) == n + n % 2 - 1
    seen = []
    for pairs in rounds:
        flat = [i for pq in pairs for i in pq]
        assert len(set(flat)) == len(flat)
        assert all(0 <= p < q < n for p, q in pairs)
        seen += pairs
    assert sorted(seen) == [(p, q) for p in range(n) for q in range(p + 1, n)]


@pytest.mark.parametrize("n", range(1, 17))
def test_twin_random_spd_each_n(n):
    """Random symmetric positive definite matrices, each n from 1 to 16."""
    rng = np.random.default_rng(200 + n)
    M = rng.normal(size=(40, n, n + 3)).astype(np.float32)
    A = M @ M.transpose(0, 2, 1)
    _check(A, *small_eigh.eigh_jacobi_reference(torch.from_numpy(A)))


@pytest.mark.parametrize("case", ["minimal_random", "minimal_posed",
                                  "posed_60"])
def test_twin_eight_point_normal_matrices(case):
    """The 8-point normal matrices, minimal (rank 8: nearly singular in
    float32) and of 60 rows, of random coordinates or of correspondences
    under a random pose: eigenvalues, residual, orthogonality, and the null
    vector (most posed minimal samples have no clear gap: there only the
    conditioned bound holds it)."""
    rng = np.random.default_rng(len(case))
    if case == "minimal_random":
        A = _random_normal(rng, 512, 8)
    else:
        A = _eight_point_normal(rng, 512, 8 if case == "minimal_posed" else 60)
    w, V = small_eigh.eigh_jacobi_reference(torch.from_numpy(A))
    _check(A, w, V)
    held = _null_vectors(A, V)
    assert held > 10 or case == "minimal_posed"


@pytest.mark.parametrize("points", [4, 60])
def test_twin_dlt_normal_matrices(points):
    """The DLT normal matrices of a homography, minimal (4 points, rank
    8) and of 60 points: as the 8-point case."""
    A = _dlt_normal(np.random.default_rng(points), 256, points)
    w, V = small_eigh.eigh_jacobi_reference(torch.from_numpy(A))
    _check(A, w, V)
    assert _null_vectors(A, V) > 100 or points == 4


@pytest.mark.parametrize("seed", [0, 1])
def test_twin_gram_3x3(seed):
    """AᵀA of 3x3 matrices, the SVD's Gram matrices (``svd3_from_eigh``),
    and of nearly singular ones (an essential matrix's)."""
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(2000, 3, 3))
    if seed:
        U, _, Vt = np.linalg.svd(M)
        M = U @ (np.array([1.0, 1.0, 1e-4])[:, None] * Vt)
    M = M.astype(np.float32)
    A = M.transpose(0, 2, 1) @ M
    _check(A, *small_eigh.eigh_jacobi_reference(torch.from_numpy(A)))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 9, 16])
def test_twin_zero_matrix_is_exact(n):
    """A zero matrix: w = 0 and V = I exactly (every rotation the
    identity)."""
    w, V = small_eigh.eigh_jacobi_reference(torch.zeros(3, n, n))
    assert torch.equal(w, torch.zeros(3, n))
    assert torch.equal(V, torch.eye(n).expand(3, n, n))


@pytest.mark.parametrize("n", [3, 9])
def test_twin_repeated_eigenvalues(n):
    """Repeated eigenvalues, on the diagonal and rotated by an orthogonal
    matrix: ascending, residual and orthogonality within EIGH_TOL."""
    rng = np.random.default_rng(n)
    d = np.array([2.0, 2.0, 1e-3, 2.0, 5.0, 5.0, -1.0, 2.0, 0.0])[:n]
    Q = np.linalg.qr(rng.normal(size=(n, n)))[0]
    A = np.stack([np.diag(d), Q @ np.diag(d) @ Q.T]).astype(np.float32)
    _check(A, *small_eigh.eigh_jacobi_reference(torch.from_numpy(A)))


def test_twin_reads_the_lower_triangle():
    """Only the lower triangle is read, as LAPACK's default ('L') reads
    it: junk above the diagonal gives the bits of the mirrored matrix."""
    S = torch.randn(10, 5, 5, generator=torch.Generator().manual_seed(3))
    L = torch.tril(S) + torch.tril(S, -1).transpose(-1, -2)
    w, V = small_eigh.eigh_jacobi_reference(S)
    wl, Vl = small_eigh.eigh_jacobi_reference(L)
    assert torch.equal(w, wl) and torch.equal(V, Vl)
    _check(L.numpy(), w, V)


@pytest.mark.parametrize("n", [3, 9])
def test_twin_non_finite_gives_nan(n):
    """A NaN or an infinity in the lower triangle gives NaN in that
    matrix's w and V and leaves its neighbours as they are; one above the
    diagonal is not read."""
    rng = np.random.default_rng(n)
    M = rng.normal(size=(5, n, n + 2)).astype(np.float32)
    A = torch.from_numpy(M @ M.transpose(0, 2, 1))
    clean = small_eigh.eigh_jacobi_reference(A)
    A[1, n - 1, 0] = float("nan")
    A[3, 1, 1] = float("inf")
    A[4, 0, n - 1] = float("nan")
    w, V = small_eigh.eigh_jacobi_reference(A)
    for k in (1, 3):
        assert torch.isnan(w[k]).all() and torch.isnan(V[k]).all()
    for k in (0, 2, 4):
        assert torch.equal(w[k], clean[0][k]) and torch.equal(V[k],
                                                              clean[1][k])
    w, _ = small_eigh.eigh_jacobi_reference(torch.full((2, n, n),
                                                       float("nan")))
    assert torch.isnan(w).all()


def test_twin_batch_dims_and_identity_sweeps():
    """Batch dimensions are kept; a matrix that has converged is left bit
    for bit as it was by further sweeps (the kernel's warp runs until all
    its matrices have), so each result is its own."""
    rng = np.random.default_rng(7)
    A = _eight_point_normal(rng, 24, 12).reshape(2, 3, 4, 9, 9)
    w, V = small_eigh.eigh_jacobi_reference(torch.from_numpy(A))
    assert w.shape == (2, 3, 4, 9) and V.shape == (2, 3, 4, 9, 9)
    _check(A.reshape(24, 9, 9), w.reshape(24, 9), V.reshape(24, 9, 9))
    for k in (0, 7, 23):
        one = small_eigh.eigh_jacobi_reference(
            torch.from_numpy(A.reshape(24, 9, 9)[k:k + 1]))
        assert torch.equal(one[0][0], w.reshape(24, 9)[k])
        assert torch.equal(one[1][0], V.reshape(24, 9, 9)[k])


def test_cpu_eigh_stays_lapack():
    """On a CPU tensor ``eigh`` is LAPACK's syevd (the plain version), not
    the twin, and counts no launch."""
    A = torch.from_numpy(_eight_point_normal(np.random.default_rng(9), 16,
                                             8))
    before = small_eigh.eigh.launches
    w, V = small_eigh.eigh(A)
    w_ref, V_ref = small_eigh.eigh_reference(A)
    assert torch.equal(w, w_ref) and torch.equal(V, V_ref)
    assert small_eigh.eigh.launches == before


def test_kernel_source_matches_the_twin():
    """The kernel's sweep cap, size limit and schedule are the twin's: the
    same cap and limit constants, and the circle method's slot formulas."""
    text = (_build.SRC_DIR / "small_eigh.cu").read_text()
    assert f"constexpr int kMaxSweeps = {small_eigh.MAX_SWEEPS};" in text
    assert f"constexpr int kMaxN = {small_eigh.MAX_N};" in text
    assert "return k == 0 ? m - 1 : (r + k) % (m - 1);" in text
    assert "return k == 0 ? r : (r - k + m - 1) % (m - 1);" in text
    for n in range(1, 17):
        assert f"case {n}: return launch<{n}>" in text or n == 16


def test_ptxas_stack_frames_by_kernel():
    """The build record's stack frame bytes per kernel: a subroutine's
    (IEEE division's slow path) is not a kernel's."""
    log = """ptxas info    : Compiling entry function '_Zk1' for 'sm_90a'
ptxas info    : Function properties for __internal_0_slowpath
    8 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Function properties for _Zk1
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 90 registers, used 1 barriers
ptxas info    : Compiling entry function '_Zk2' for 'sm_90a'
ptxas info    : Function properties for _Zk2
    24 bytes stack frame, 24 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 80 registers
"""
    assert _build.ptxas_stack_frames(["", log]) == {"_Zk1": 0, "_Zk2": 24}


def test_smoke_run_holds_the_pose_sizes_to_registers():
    """``chip_smoke.eigh_resources`` lists the sixteen instantiations and
    refuses a stack frame or a spill at n = 3 or n = 9, the pose path's
    sizes, as ptxas reports them."""
    import chip_smoke

    def name(n):
        kind = "thread" if n <= 3 else "lanes"
        return (f"_ZN12_GLOBAL__N_1{len(kind) + 16}sym_eigh_kernel_{kind}"
                f"ILi{n}EEEvPKfPfS3_x")

    record = {"resources": {name(n): {"spill_stores": 0, "spill_loads": 0,
                                      "registers": 40 + n}
                            for n in range(1, 17)},
              "stack_frames": {name(n): 0 for n in range(1, 17)}}
    rows = chip_smoke.eigh_resources(record)
    assert [r["n"] for r in rows] == list(range(1, 17))
    assert rows[8]["kernel"] == "eigh lanes n=9" and rows[8]["stack_frame"] == 0
    record["stack_frames"][name(12)] = 16
    assert chip_smoke.eigh_resources(record)[11]["stack_frame"] == 16
    for n, key, value in ((9, "stack", 8), (3, "spill_stores", 4)):
        bad = {"resources": {k: dict(v) for k, v in record["resources"].items()},
               "stack_frames": dict(record["stack_frames"])}
        if key == "stack":
            bad["stack_frames"][name(n)] = value
        else:
            bad["resources"][name(n)][key] = value
        with pytest.raises(AssertionError):
            chip_smoke.eigh_resources(bad)
    del record["resources"][name(16)]
    with pytest.raises(AssertionError):
        chip_smoke.eigh_resources(record)


def test_pose_timing_needs_a_card(monkeypatch, capsys):
    """Without a CUDA card the timing script exits 1 before it measures."""
    import pose_timing

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "path", list(sys.path))
    assert pose_timing.main([]) == 1
    assert "needs a CUDA card" in capsys.readouterr().err
