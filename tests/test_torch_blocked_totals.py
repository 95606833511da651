"""The measurement kernel (``kernels.measure.blocked_totals``): exact int64
spin and bond sums of blocked quads, and the dispatch in
``core.measure.blocked_totals``.

On the CPU the wrapper runs its plain version, which must equal the f32
matmul chain (``core.measure``, the JAX package's bits, held in
``test_torch_core.py``) and the ``observables`` oracles exactly. The tests
marked ``cuda`` hold the CUDA kernel against the plain version on the card
and skip without one. This file imports no JAX.
"""
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch import random as jr  # noqa: E402
from repro_torch.core import checkerboard as cb  # noqa: E402
from repro_torch.core import measure as M  # noqa: E402
from repro_torch.core import observables as O  # noqa: E402
from repro_torch.core import sampler  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import measure as K  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

BETA = 0.4406868


def _quads(seed, height, width, dtype=torch.bfloat16, hot=True,
           device="cpu"):
    return sampler.init_state(jr.PRNGKey(seed), height, width, dtype, hot,
                              device)


def _totals(pair: torch.Tensor, n_spins: int) -> M.Totals:
    m_sum, e_sum = pair.to(torch.float32)
    return M.Totals(m_sum, e_sum, n_spins)


def _check_against_chain_and_oracles(quads, bs):
    qb = ops._block_quads(quads, bs)
    plain = K.blocked_totals_plain(qb)
    chain = M.blocked_totals(qb)
    assert plain.dtype == torch.int64
    assert [float(chain.m_sum), float(chain.e_sum)] == plain.tolist()
    got = _totals(plain, chain.n_spins).means()
    want = chain.means()
    assert [float(x) for x in got] == [float(x) for x in want]
    assert float(got[0]) == float(O.magnetization(quads))
    assert float(got[1]) == float(O.energy_per_spin(quads))
    return plain


# tile positions on the edges and corners of a bs x bs tile
def _edge_sites(bs):
    mid = bs // 2
    return [(0, 0), (0, bs - 1), (bs - 1, 0), (bs - 1, bs - 1), (0, mid),
            (mid, 0), (bs - 1, mid), (mid, bs - 1)]


@pytest.mark.parametrize("size", [64, 256])
@pytest.mark.parametrize("bs", [8, 16, 32])
@pytest.mark.parametrize("hot", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plain_equals_chain_and_oracles(size, bs, hot, dtype):
    _check_against_chain_and_oracles(_quads(size + bs, size, size, dtype, hot),
                                     bs)


def test_cold_lattice_totals():
    """All up: m_sum = N spins, e_sum = 2N (every bond once, each +1)."""
    quads = _quads(0, 64, 64, hot=False)
    n = quads.numel()
    assert _check_against_chain_and_oracles(quads, 16).tolist() == [n, 2 * n]


@pytest.mark.parametrize("quad", range(4))
@pytest.mark.parametrize("tile", [(0, 0), (1, 2), (3, 3)])
@pytest.mark.parametrize("hot", [False, True])
def test_one_flip_at_each_tile_edge_and_corner(quad, tile, hot):
    """One site flipped at each edge and corner of a tile (the torus'
    corner tile, an inner one and the last one), in each quad: every halo
    read of the kernel's neighbour sets. On the cold lattice a flip costs 4
    bonds: e_sum = 2N - 8."""
    bs, size = 16, 128
    base = _quads(7, size, size, hot=hot)
    n = base.numel()
    for i, j in _edge_sites(bs):
        quads = base.clone()
        r, c = tile[0] * bs + i, tile[1] * bs + j
        quads[quad, r, c] = -quads[quad, r, c]
        got = _check_against_chain_and_oracles(quads, bs).tolist()
        if not hot:
            assert got == [n - 2, 2 * n - 8]


def test_rectangular_tile_grid():
    """mr != mc, both ways."""
    for h, w in ((64, 128), (128, 64)):
        _check_against_chain_and_oracles(_quads(h + w, h, w), 16)


def test_cpu_and_halo_tuples_take_the_chain(monkeypatch):
    """A CPU stack, and a tuple with a halo edges provider (what the mesh
    and opt runners pass), never reach the kernel's wrapper, and the
    launch count stays 0."""
    def refuse(qb):
        raise AssertionError("the kernel wrapper was called")

    qb = ops._block_quads(_quads(3, 64, 64), 16)
    chain = M.blocked_totals(qb)
    build.reset_launches()
    monkeypatch.setattr(K, "blocked_totals", refuse)
    got = M.blocked_totals(qb)
    assert got.m_sum.dtype == torch.float32
    assert (float(got.m_sum), float(got.e_sum)) == \
        (float(chain.m_sum), float(chain.e_sum))

    def edges(xb, side):
        return cb.default_edges(xb, side)

    tup = M.blocked_totals(qb.unbind(0), 4 * qb[0].numel(), edges=edges)
    assert (float(tup.m_sum), float(tup.e_sum)) == \
        (float(chain.m_sum), float(chain.e_sum))
    assert [float(x) for x in M.blocked_stats(qb)] == \
        [float(x) for x in chain.means()]
    assert build.launches == dict.fromkeys(build.launches, 0)


@pytest.mark.parametrize("shape", [(3, 2, 2, 16, 16), (4, 2, 2, 16, 8),
                                   (4, 2, 16, 16), (4, 1, 1, 1, 16, 16)])
def test_wrapper_refuses_a_wrong_shape(shape):
    with pytest.raises(ValueError, match=r"\[4, mr, mc, bs, bs\]"):
        K.blocked_totals(torch.ones(shape, dtype=torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int8])
def test_wrapper_refuses_a_wrong_dtype(dtype):
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        K.blocked_totals(torch.ones((4, 1, 1, 16, 16), dtype=dtype))


# ---------------------------------------------------------------------------
# On the card (marked cuda; skipped without one)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1024, 1024), (4096, 4096), (1024, 2048),
                                   (2048, 1024)])
@pytest.mark.parametrize("bs", [16, 32, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_equals_plain(cuda, shape, bs, dtype):
    quads = _quads(shape[0] + bs, *shape, dtype, device=cuda)
    qb = ops._block_quads(quads, bs)
    build.reset_launches()
    got = K.blocked_totals(qb)
    assert got.device.type == "cuda" and got.dtype == torch.int64
    assert got.tolist() == K.blocked_totals_plain(qb.cpu()).tolist()
    assert build.launches["blocked_totals"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [12, 24, 64])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_generic_and_unaligned(cuda, bs, dtype):
    """bs without a vector instantiation, and quads that start off a
    16-byte boundary, take the generic form."""
    quads = _quads(bs, 4 * bs, 6 * bs, dtype, device=cuda)
    qb = ops._block_quads(quads, bs)
    assert K.blocked_totals(qb).tolist() == \
        K.blocked_totals_plain(qb.cpu()).tolist()
    store = torch.empty(qb.numel() + 1, dtype=dtype, device=cuda)
    shifted = store[1:].view(qb.shape)
    shifted.copy_(qb)
    assert shifted.data_ptr() % 16
    assert K.blocked_totals(shifted).tolist() == \
        K.blocked_totals_plain(qb.cpu()).tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [16, 128])
def test_kernel_one_flip_at_each_tile_edge_and_corner(cuda, bs):
    size = 4 * bs
    base = _quads(0, size, 2 * size, hot=False, device=cuda)
    n = base.numel()
    for quad in range(4):
        for tile in ((0, 0), (1, 2), (size // 2 // bs - 1, size // bs - 1)):
            for i, j in _edge_sites(bs):
                quads = base.clone()
                quads[quad, tile[0] * bs + i, tile[1] * bs + j] = -1
                qb = ops._block_quads(quads, bs)
                assert K.blocked_totals(qb).tolist() == [n - 2, 2 * n - 8]


@pytest.mark.cuda
def test_kernel_refuses_non_contiguous_quads(cuda):
    qb = torch.ones((4, 2, 2, 16, 16), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        K.blocked_totals(qb.transpose(1, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["pallas", "pallas_lines"])
def test_measured_engine_series_equal_the_chain(cuda, backend):
    """A measured 2048^2 run on a kernel backend streams the (m, E) of the
    chain form bit for bit (sums below 2**24, exact in f32), one kernel
    launch a sweep."""
    from repro_torch.api import EngineConfig, IsingEngine
    sweeps = 4
    cfg = EngineConfig(size=2048, beta=BETA, n_sweeps=sweeps,
                       backend=backend, block_size=128, hot=True)
    eng = IsingEngine(cfg, device=cuda)
    key = jr.PRNGKey(5)
    state = eng.init(jr.PRNGKey(6))
    build.reset_launches()
    res = eng.run(state, key)
    assert build.launches["blocked_totals"] == sweeps
    qb = ops._block_quads(state.to(cuda), 128)
    ms, es = [], []
    for step in range(sweeps):
        qb = ops.sweep_blocked(qb, key, step, BETA, backend, cfg.kernel_rule())
        m, e = M.blocked_stats(qb.unbind(0))     # a tuple: the f32 chain
        ms.append(float(m))
        es.append(float(e))
    assert res.magnetization.tolist() == ms
    assert res.energy.tolist() == es
    assert build.launches["blocked_totals"] == sweeps
