"""``random.fold_in_bits`` and its device kernel (``kernels.rng``).

On the CPU ``fold_in_bits`` runs its eager int64 form, held here to the
host ``fold_in`` of every counter (``test_torch_cluster.py``,
``test_torch_potts.py`` and ``test_torch_ising3d.py`` hold it to the JAX
package). The tests marked ``cuda`` hold the CUDA kernel bit for bit
against the eager form on the card and skip without one. This file imports
no JAX.
"""
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch import random as jr  # noqa: E402
from repro_torch.api import EngineConfig, IsingEngine  # noqa: E402
from repro_torch.cluster import bonds as B  # noqa: E402
from repro_torch.cluster import sweep as CS  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import rng  # noqa: E402

EDGES = [0, 1, 2, 3, 2 ** 31 - 1, -1, -2 ** 31, -(2 ** 31) + 1, 12345678]
KEYS = [jr.PRNGKey(0), jr.PRNGKey(-7), (0xFFFFFFFF, 0x80000001),
        jr.fold_in(jr.PRNGKey(3), 1)]


def _signed(w: int) -> int:
    return w - ((w >> 31) << 32)


def _host(key, values) -> list:
    """The last word of the host ``fold_in`` of each value, as int32."""
    return [_signed(jr.fold_in(key, v)[1]) for v in values]


def _counters(n: int, seed: int, device="cpu") -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    c = torch.randint(-2 ** 31, 2 ** 31, (n,), generator=g,
                      dtype=torch.int64).to(torch.int32)
    k = min(n, len(EDGES))
    c[:k] = torch.tensor(EDGES[:k], dtype=torch.int32)
    return c.to(device)


def _zero():
    jr.reset_counters()
    build.reset_launches()


# ---------------------------------------------------------------------------
# On the CPU: the eager form
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key", KEYS)
def test_cpu_takes_the_eager_form(key):
    _zero()
    c = _counters(37, 1)
    got = jr.fold_in_bits(key, c)
    assert got.dtype == torch.int32 and got.shape == c.shape
    assert got.tolist() == _host(key, c.tolist())
    assert jr.counters == {"fold_in_bits_eager": 1, "draw_words": 0}
    assert build.launches == dict.fromkeys(build.launches, 0)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_eager_form_of_a_key_batch(dtype):
    keys = KEYS[:3]
    c = _counters(3 * 11, 2).view(3, 11).to(dtype)
    got = jr.fold_in_bits(keys, c)
    for i, k in enumerate(keys):
        assert got[i].tolist() == _host(k, c[i].tolist())
    shared = jr.fold_in_bits(keys, jr.shared(keys, c[0]))
    for i, k in enumerate(keys):
        assert shared[i].tolist() == _host(k, c[0].tolist())


def test_eager_form_of_int64_counters_hashes_the_low_word():
    key = KEYS[1]
    c = torch.tensor([5, 5 + 2 ** 32, -1, 2 ** 32 - 1], dtype=torch.int64)
    before = c.clone()
    got = jr.fold_in_bits(key, c).tolist()
    assert torch.equal(c, before)        # the counters are left as they were
    assert got[0] == got[1] and got[2] == got[3]
    assert got == _host(key, [5, 5, 2 ** 32 - 1, 2 ** 32 - 1])


def test_cpu_sweep_counts_three_eager_passes():
    """A Swendsen-Wang sweep draws two bond hashes and one coin hash."""
    full = torch.ones(16, 16, dtype=torch.float32)
    _zero()
    CS.cluster_sweep(full, jr.PRNGKey(4), B.bond_threshold_u24(0.3))
    assert jr.counters == {"fold_in_bits_eager": 3, "draw_words": 0}
    assert build.launches == dict.fromkeys(build.launches, 0)


def test_kernel_wrapper_runs_the_eager_form_on_the_cpu():
    """On CPU counters the wrapper runs its plain version, the eager form
    (``test_torch_kernels.py`` holds its refusal of other devices); it
    takes int32 counters only."""
    _zero()
    c = _counters(37, 4)
    assert rng.fold_in_bits(KEYS[1], c).tolist() == _host(KEYS[1],
                                                          c.tolist())
    assert jr.counters == {"fold_in_bits_eager": 1, "draw_words": 0}
    assert build.launches == dict.fromkeys(build.launches, 0)
    with pytest.raises(TypeError, match="int32"):
        rng.fold_in_bits(KEYS[1], c.long())


@pytest.mark.parametrize("betas", [None, (0.3, 0.45)])
def test_cpu_chain_counts_three_eager_passes_a_sweep(betas):
    kw = dict(size=32, n_sweeps=3, algorithm="swendsen_wang", measure=True)
    kw.update(dict(betas=betas) if betas else dict(beta=0.4406868))
    _zero()
    IsingEngine(EngineConfig(**kw), device="cpu").simulate(11)
    # the hot start of the 0.3 replica draws its 32^2 spins, the cold one
    # (and beta_c's) none
    assert jr.counters == {"fold_in_bits_eager": 3 * kw["n_sweeps"],
                           "draw_words": 32 * 32 if betas else 0}
    assert build.launches == dict.fromkeys(build.launches, 0)


# ---------------------------------------------------------------------------
# On the card (marked cuda; skipped without one)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


def _kernel_equals_eager(key, c):
    """The kernel's bits for ``c`` (through ``fold_in_bits``, one launch)
    equal the eager form's on the same device."""
    build.reset_launches()
    got = jr.fold_in_bits(key, c)
    assert build.launches["fold_in_bits"] == int(c.numel() > 0)
    assert got.dtype == torch.int32 and got.shape == c.shape
    assert got.device == c.device
    assert torch.equal(got, jr._fold_in_bits_eager(key, c))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 4099, jr.CHUNK + 3])
@pytest.mark.parametrize("key", KEYS[:2])
def test_kernel_single_key(cuda, key, n):
    c = _counters(n, n, cuda)
    got = _kernel_equals_eager(key, c)
    k = min(n, 64)
    assert got[:k].tolist() == _host(key, c[:k].tolist())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 5, 4096, 4099, jr.CHUNK // 2 + 1])
def test_kernel_key_batch_distinct_and_shared_rows(cuda, n):
    keys = KEYS[:3]
    c = _counters(3 * n, n + 1, cuda).view(3, n)
    _kernel_equals_eager(keys, c)
    shared = jr.shared(keys, c[0])
    assert shared.stride(0) == 0
    got = _kernel_equals_eager(keys, shared)
    for i, k in enumerate(keys):
        assert got[i, :8].tolist() == _host(k, c[0, :8].tolist())


@pytest.mark.cuda
def test_kernel_shared_rows_of_a_lattice(cuda):
    """``jr.shared`` over a 2-D index grid, as the Potts rules and the 3-D
    sweep pass it: read in place, never copied R times."""
    keys = [jr.fold_in(jr.PRNGKey(9), i) for i in range(4)]
    gi = B.global_index(96, 40, device=cuda)
    _kernel_equals_eager(keys, jr.shared(keys, gi))


@pytest.mark.cuda
def test_kernel_edge_counters(cuda):
    c = torch.tensor(EDGES * 3, dtype=torch.int32, device=cuda)
    for key in KEYS:
        got = _kernel_equals_eager(key, c)
        assert got.tolist() == _host(key, c.tolist())


@pytest.mark.cuda
def test_kernel_non_contiguous_and_unaligned_counters(cuda):
    key, keys = KEYS[2], KEYS[:2]
    c = _counters(2 * 64 * 70, 5, cuda)
    _kernel_equals_eager(key, c.view(64, 140).t())          # transposed
    _kernel_equals_eager(key, c[::3])                        # strided
    _kernel_equals_eager(key, c[1:4099])                     # off 16 bytes
    assert c[1:].data_ptr() % 16
    _kernel_equals_eager(keys, c.view(2, 64, 70)[:, :, 1:])  # strided rows
    _kernel_equals_eager(keys, c[1:2 * 4099 + 1].view(2, 4099))
    _kernel_equals_eager(keys, c[:2 * 4099].view(2, 4099))   # row 1 off


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int64, torch.int16, torch.uint8,
                                   torch.bool])
def test_kernel_takes_other_integer_dtypes(cuda, dtype):
    """Integer counters of another dtype take the kernel, cast to int32:
    the low 32-bit word, as the eager form hashes them."""
    wide = [5, 5 + 2 ** 32, -1, 2 ** 32 - 1, 2 ** 31, -2 ** 33 + 7, 0, 1]
    c = torch.tensor(wide, dtype=torch.int64).to(dtype).to(cuda)
    keys = KEYS[:2]
    for key, cc in ((KEYS[3], c), (keys, jr.shared(keys, c)),
                    (keys, c.view(2, 4))):
        _zero()
        got = jr.fold_in_bits(key, cc)
        assert build.launches["fold_in_bits"] == 1
        assert jr.counters == {"fold_in_bits_eager": 0, "draw_words": 0}
        assert got.dtype == torch.int32 and got.shape == cc.shape
        assert torch.equal(got, jr._fold_in_bits_eager(key, cc))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_refuses_float_counters(cuda, dtype):
    _zero()
    with pytest.raises(TypeError, match="integer counters"):
        jr.fold_in_bits(KEYS[0], torch.zeros(8, dtype=dtype, device=cuda))
    assert build.launches["fold_in_bits"] == 0
    assert jr.counters == {"fold_in_bits_eager": 0, "draw_words": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("betas", [None, (0.3, 0.45)])
def test_swendsen_wang_chain_on_the_card_equals_the_cpu(cuda, betas):
    """A measured 256^2 SW chain (a key batch with two betas) leaves the
    same lattice and series on the card as on the CPU, every hash on the
    card in the kernel."""
    kw = dict(size=256, n_sweeps=4, algorithm="swendsen_wang", measure=True)
    kw.update(dict(betas=betas) if betas else dict(beta=0.4406868))
    cpu = IsingEngine(EngineConfig(**kw), device="cpu").simulate(11)
    _zero()
    card = IsingEngine(EngineConfig(**kw), device=cuda).simulate(11)
    # the 0.3 replica's hot start draws its spins
    assert jr.counters == {"fold_in_bits_eager": 0,
                           "draw_words": 256 * 256 if betas else 0}
    assert build.launches["fold_in_bits"] == 3 * kw["n_sweeps"]
    assert torch.equal(card.state.cpu(), cpu.state)
    assert torch.equal(card.magnetization.cpu(), cpu.magnetization)
    assert torch.equal(card.energy.cpu(), cpu.energy)


@pytest.mark.cuda
def test_one_sweep_on_the_card_is_three_launches(cuda):
    full = torch.where(torch.rand(512, 512, generator=torch.Generator()
                                  .manual_seed(2)) < 0.5, -1.0, 1.0)
    t = B.bond_threshold_u24(0.35)
    want = CS.cluster_sweep(full, jr.PRNGKey(8), t)
    _zero()
    got = CS.cluster_sweep(full.to(cuda), jr.PRNGKey(8), t)
    assert build.launches["fold_in_bits"] == 3
    assert jr.counters == {"fold_in_bits_eager": 0, "draw_words": 0}
    assert torch.equal(got.cpu(), want)
