"""``cluster.label.label_components`` and its device kernel
(``kernels.label``).

On the CPU ``label_components`` runs the plain min-label propagation
(``cluster.label.propagate``), held here to scipy's connected components on
the graphs the kernel is tested on (``test_torch_cluster.py`` holds it to
the JAX package, iteration counts included). The tests marked ``cuda``
hold the union-find kernel bit for bit against the propagation and scipy
on the card and skip without one. This file imports no JAX.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch import random as jr  # noqa: E402
from repro_torch.api import EngineConfig, IsingEngine  # noqa: E402
from repro_torch.cluster import bonds as B  # noqa: E402
from repro_torch.cluster import label as LBL  # noqa: E402
from repro_torch.cluster import sweep as CS  # noqa: E402
from repro_torch.core import lattice as L  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import label as K  # noqa: E402

BETA_SW = 0.4006244          # the sw-near-critical cell's beta (1.1 T_c)
PROBS = [0.15, 0.5, 0.85]
RAGGED = [(37, 53), (1, 64), (64, 1), (1, 1), (2, 2), (33, 32), (96, 130)]


def _scipy_labels(br: np.ndarray, bd: np.ndarray) -> np.ndarray:
    """Canonical min-index labels of each [H, W] torus graph of a stack,
    from scipy's connected components."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    if br.ndim > 2:
        return np.stack([_scipy_labels(r, d) for r, d in zip(br, bd)])
    h, w = br.shape
    n = h * w
    idx = np.arange(n).reshape(h, w)
    rows = np.concatenate([idx[br], idx[bd]])
    cols = np.concatenate([np.roll(idx, -1, 1)[br], np.roll(idx, -1, 0)[bd]])
    g = coo_matrix((np.ones(len(rows)), (rows, cols)), shape=(n, n))
    _, comp = connected_components(g, directed=False)
    low = np.full(comp.max() + 1, n)
    np.minimum.at(low, comp, np.arange(n))
    return low[comp].astype(np.int32).reshape(h, w)


def _random(shape, p, seed):
    rng = np.random.default_rng(seed)
    return rng.random(shape) < p, rng.random(shape) < p


def _serpentine(h, w):
    """One cluster that winds through every row: the propagation's worst
    case, and a chain of tile roots for the kernel."""
    br = np.ones((h, w), bool)
    br[:, -1] = False
    bd = np.zeros((h, w), bool)
    for i in range(h - 1):
        bd[i, -1 if i % 2 == 0 else 0] = True
    return br, bd


def _wrapping(h, w):
    """Clusters joined only across the torus's seams: row 3 is one cluster
    through its east-west wrap bond alone, column 5 through its north-south
    wrap bond alone, and a pair (0, W-1), (H-1, W-1) whose smallest index
    lies across the corner."""
    br = np.zeros((h, w), bool)
    bd = np.zeros((h, w), bool)
    br[3, :] = True
    br[3, w // 2] = False          # the row closes only through the wrap
    bd[:, 5] = True
    bd[h // 2, 5] = False          # the column closes only through the wrap
    br[h - 1, w - 1] = True        # (H-1, W-1) -> (H-1, 0)
    bd[h - 1, 0] = True            # (H-1, 0) -> (0, 0)
    return br, bd


GRAPHS = {
    "serpentine-8": lambda: _serpentine(8, 8),
    "serpentine-70x45": lambda: _serpentine(70, 45),
    "wrapping-40x70": lambda: _wrapping(40, 70),
    "wrapping-64x64": lambda: _wrapping(64, 64),
    "open-33x65": lambda: (np.ones((33, 65), bool),) * 2,
    "closed-33x65": lambda: (np.zeros((33, 65), bool),) * 2,
    "rows-only-64x96": lambda: (np.ones((64, 96), bool),
                                np.zeros((64, 96), bool)),
    "columns-only-64x96": lambda: (np.zeros((64, 96), bool),
                                   np.ones((64, 96), bool)),
}


def _t(a, device="cpu"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


# ---------------------------------------------------------------------------
# On the CPU: the plain propagation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(GRAPHS))
def test_cpu_propagation_matches_scipy_on_the_kernel_graphs(name):
    br, bd = GRAPHS[name]()
    build.reset_launches()
    got = LBL.label_components(_t(br), _t(bd))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _scipy_labels(br, bd))
    assert build.launches["label_components"] == 0


@pytest.mark.parametrize("hw", RAGGED)
def test_cpu_propagation_matches_scipy_on_ragged_shapes(hw):
    br, bd = _random(hw, 0.6, hw[0] * 131 + hw[1])
    np.testing.assert_array_equal(
        LBL.label_components(_t(br), _t(bd)).numpy(), _scipy_labels(br, bd))


def test_cpu_takes_the_propagation_and_counts_no_launch():
    """A CPU tensor runs the plain version unchanged: its labels and its
    iterations, counted in ``counters``, and no kernel launch."""
    br, bd = _random((3, 20, 24), 0.55, 7)
    build.reset_launches()
    LBL.reset_counters()
    lab, iters = LBL.label_components(_t(br), _t(bd), with_iters=True)
    plain, plain_iters = LBL.propagate(_t(br), _t(bd))
    assert torch.equal(lab, plain) and iters == plain_iters > 1
    assert LBL.counters["iterations"] == 2 * iters
    assert build.launches == dict.fromkeys(build.launches, 0)
    np.testing.assert_array_equal(lab.numpy(), _scipy_labels(br, bd))


def test_kernel_wrapper_runs_the_propagation_on_the_cpu():
    br, bd = _random((12, 10), 0.5, 3)
    build.reset_launches()
    got = K.label_components(_t(br), _t(bd))
    assert torch.equal(got, LBL.propagate(_t(br), _t(bd))[0])
    assert build.launches["label_components"] == 0


def test_meta_masks_raise():
    """``label_components`` hands masks on neither CPU nor CUDA to the
    kernel wrapper, which raises (``test_torch_kernels.py`` holds the
    wrapper's message) and counts nothing."""
    m = torch.zeros((8, 8), dtype=torch.bool, device="meta")
    build.reset_launches()
    LBL.reset_counters()
    with pytest.raises(ValueError, match="CUDA or CPU"):
        LBL.label_components(m, m)
    assert build.launches["label_components"] == 0
    assert LBL.counters["iterations"] == 0


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    z = torch.zeros((4, 6), dtype=torch.bool)
    with pytest.raises(TypeError, match="bool"):
        K.label_components(z.to(torch.uint8), z)
    with pytest.raises(ValueError, match="shape"):
        K.label_components(z, z[:, :5])
    with pytest.raises(ValueError, match="shape"):
        K.label_components(z[0], z[0])


# ---------------------------------------------------------------------------
# On the card (marked cuda; skipped without one)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


def _kernel_equals_plain(br, bd, device, scipy=True):
    """The kernel's labels (through ``label_components``, one launch, no
    iteration) equal the propagation's on the card, and scipy's."""
    right, down = _t(br, device), _t(bd, device)
    build.reset_launches()
    LBL.reset_counters()
    got, iters = LBL.label_components(right, down, with_iters=True)
    assert build.launches["label_components"] == 1
    assert iters == 0 and LBL.counters["iterations"] == 0
    assert got.dtype == torch.int32 and got.shape == right.shape
    assert got.device == right.device and got.is_contiguous()
    assert torch.equal(got, LBL.propagate(right, down)[0])
    if scipy:
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      _scipy_labels(br, bd))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("p", PROBS)
@pytest.mark.parametrize("hw", RAGGED + [(256, 256), (160, 320)])
def test_kernel_random_masks(cuda, hw, p):
    for seed in range(3):
        _kernel_equals_plain(*_random(hw, p, seed), cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(GRAPHS))
def test_kernel_edge_graphs(cuda, name):
    _kernel_equals_plain(*GRAPHS[name](), cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(96, 64), (37, 53)])
def test_kernel_stack_is_each_graph_alone(cuda, hw):
    br, bd = _random((4,) + hw, 0.55, 11)
    lab = _kernel_equals_plain(br, bd, cuda)
    for i in range(4):
        one = _kernel_equals_plain(br[i], bd[i], cuda, scipy=False)
        assert torch.equal(lab[i], one)
    _kernel_equals_plain(*_random((2, 3) + hw, 0.5, 12), cuda)


@pytest.mark.cuda
def test_kernel_takes_non_contiguous_masks(cuda):
    br, bd = _random((80, 66), 0.6, 5)
    right, down = _t(br, cuda), _t(bd, cuda)
    # the transposed graph: the masks swap roles
    t_right, t_down = down.t(), right.t()
    assert not t_right.is_contiguous()
    build.reset_launches()
    got = LBL.label_components(t_right, t_down)
    assert build.launches["label_components"] == 1
    assert torch.equal(got, LBL.propagate(t_right, t_down)[0])


@pytest.mark.cuda
def test_kernel_empty_stack_launches_nothing(cuda):
    z = torch.zeros((0, 8, 8), dtype=torch.bool, device=cuda)
    build.reset_launches()
    assert K.label_components(z, z).shape == (0, 8, 8)
    assert build.launches["label_components"] == 0


@pytest.mark.cuda
def test_kernel_fk_bonds_at_the_cells_size(cuda):
    """One 5120^2 graph of FK bonds at the sw-near-critical cell's beta,
    on a lattice that a few sweeps brought near its equilibrium."""
    n = 5120
    t = B.bond_threshold_u24(BETA_SW)
    full = L.random_lattice(jr.PRNGKey(61), n, n, device=cuda)
    key = jr.PRNGKey(62)
    for _ in range(4):
        full = CS.cluster_sweep(full, key, t)
        key = jr.fold_in(key, 1)
    br, bd = B.fk_bonds(full, jr.fold_in(key, 0), t)
    build.reset_launches()
    got = LBL.label_components(br, bd)
    assert build.launches["label_components"] == 1
    assert torch.equal(got, LBL.propagate(br, bd)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["swendsen_wang", "wolff"])
def test_cluster_sweep_on_the_card_equals_the_cpu(cuda, algo):
    full = torch.where(torch.rand(300, 260, generator=torch.Generator()
                                  .manual_seed(4)) < 0.5, -1.0, 1.0)
    t = B.bond_threshold_u24(0.43)
    key = jr.PRNGKey(9)
    want = CS.cluster_sweep_measured(full, key, t, algo)
    build.reset_launches()
    got = CS.cluster_sweep_measured(full.to(cuda), key, t, algo)
    assert build.launches["label_components"] == 1
    assert torch.equal(got[0].cpu(), want[0])
    assert [float(v) for v in got[1]] == [float(v) for v in want[1]]


@pytest.mark.cuda
@pytest.mark.parametrize("betas", [None, (0.3, 0.45)])
def test_swendsen_wang_chain_launches_once_a_sweep(cuda, betas):
    """A measured SW chain (a key batch with two betas: one stacked launch
    a sweep) leaves the same lattice and series on the card as on the
    CPU, with no label iteration on the card."""
    kw = dict(size=128, n_sweeps=4, algorithm="swendsen_wang", measure=True)
    kw.update(dict(betas=betas) if betas else dict(beta=0.4406868))
    cpu = IsingEngine(EngineConfig(**kw), device="cpu").simulate(5)
    build.reset_launches()
    LBL.reset_counters()
    card = IsingEngine(EngineConfig(**kw), device=cuda).simulate(5)
    assert build.launches["label_components"] == kw["n_sweeps"]
    assert LBL.counters["iterations"] == 0
    assert torch.equal(card.state.cpu(), cpu.state)
    assert torch.equal(card.magnetization.cpu(), cpu.magnetization)
    assert torch.equal(card.energy.cpu(), cpu.energy)
