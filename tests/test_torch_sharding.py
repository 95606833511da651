"""The port's logical-dim spec trees and sharding rules against the JAX
package, with no ranks: every registered arch at its published config,
its parameters, both optimizers' states, its decode states and its input
batches, resolved on the production layouts (16 x 16, 2 x 16 x 16) and
the small grids the tests run (2 x 2, 1 x 2). The JAX side resolves on
``abstract_mesh`` and ``jax.eval_shape``, the port on ``meta`` tensors.
Also the cases of ``tests/test_sharding.py`` and the activation hint.
"""
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

from repro.compat import abstract_mesh  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import list_configs  # noqa: E402
from repro.configs.base import LM_SHAPES as JSHAPES  # noqa: E402
from repro.distributed import sharding as JSH  # noqa: E402
from repro.launch import dryrun_lib as jlib  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as JTS  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import LM_SHAPES  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402

LAYOUTS = [((16, 16), ("data", "model")),
           ((2, 16, 16), ("pod", "data", "model")),
           ((2, 2), ("data", "model")), ((1, 2), ("data", "model"))]
ARCHS = list_configs()


class _Leaf:
    """A placement held as one leaf (``tree.leaves`` walks into tuples)."""

    def __init__(self, value):
        self.value = value


def _port_placements(layout, dims, like, rules) -> list:
    """The port's placements in leaf order."""
    places = SH.resolve_tree(layout, dims, like, rules)
    return [x.value for x in tree.leaves(
        tree.map(lambda _, p: _Leaf(p), like, places))]


def _jax_placements(mesh, dims, like, rules) -> list:
    """The reference's resolve_tree, leaf by leaf, as tuples."""
    is_dims = lambda x: isinstance(x, tuple) or x is None  # noqa: E731
    out = jax.tree.map(
        lambda d, a: _Leaf(() if d is None else tuple(
            JSH.resolve_spec(mesh, tuple(d), a.shape, rules))),
        dims, like, is_leaf=is_dims)
    return [x.value for x in jax.tree.leaves(
        out, is_leaf=lambda x: isinstance(x, _Leaf))]


def _shapes(port_tree) -> list:
    return [(p, tuple(a.shape), str(a.dtype).replace("torch.", ""))
            for p, a in tree.paths(port_tree)]


def _jshapes(jax_tree) -> list:
    return [(jax.tree_util.keystr(p, simple=True, separator="/"),
             tuple(a.shape), str(a.dtype))
            for p, a in jax.tree_util.tree_flatten_with_path(jax_tree)[0]]


@pytest.fixture(scope="module")
def abstract():
    """Per arch: the reference's abstract train states (both optimizers)
    and parameter specs, and its decode-state trees."""
    out = {}
    for arch in ARCHS:
        cfg = jget_config(arch)
        states = {}
        for kind in ("adamw", "adafactor"):
            ocfg = jopt.OptimizerConfig(kind=kind)
            struct, specs = jlib.abstract_train_state(cfg, ocfg)
            states[kind] = (struct, JTS.state_logical_dims(
                cfg, ocfg, specs, struct["params"]))
        out[arch] = (specs, states, JM.decode_state_specs(
            cfg, JSHAPES["decode_32k"]))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_trees_equal_the_reference(abstract, arch):
    """Parameter, optimizer (AdamW and Adafactor), decode-state and batch
    dims: the same trees, leaf order and tuples; the abstract states and
    batches have the reference's paths, shapes and dtypes."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    specs, states, (jdec, jdec_dims) = abstract[arch]
    assert T.model_specs(cfg) == specs
    for kind, (struct, dims) in states.items():
        ocfg = opt.OptimizerConfig(kind=kind)
        meta = TS.init_train_state(cfg, ocfg, None, "meta")
        assert _shapes(meta) == _jshapes(struct)
        assert TS.state_logical_dims(cfg, ocfg, T.model_specs(cfg),
                                     meta["params"]) == dims
    dec, dec_dims = M.decode_state_specs(cfg, LM_SHAPES["decode_32k"])
    assert dec_dims == jdec_dims
    assert _shapes(dec) == _jshapes(jdec)
    for name, shape in LM_SHAPES.items():
        assert M.batch_logical_dims(cfg, shape) == \
            JM.batch_logical_dims(jcfg, JSHAPES[name])
        assert _shapes(M.input_specs(cfg, shape)) == \
            _jshapes(JM.input_specs(jcfg, JSHAPES[name]))


@pytest.mark.parametrize("layout", LAYOUTS,
                         ids=["x".join(map(str, s)) for s, _ in LAYOUTS])
def test_placements_equal_the_reference(abstract, layout):
    """Every arch's train state (both optimizers), decode states and input
    batches resolve on the layout, under the arch's rules, to the
    reference's PartitionSpecs entry for entry."""
    shape, axes = layout
    mesh = abstract_mesh(shape, axes)
    grid = mesh_lib.Layout(shape, axes)
    for arch in ARCHS:
        jcfg, cfg = jget_config(arch), get_config(arch)
        rules = SH.rules_for(cfg)
        assert rules == jlib.rules_for(jcfg)
        _, states, (jdec, jdec_dims) = abstract[arch]
        for kind, (struct, dims) in states.items():
            meta = TS.init_train_state(cfg, opt.OptimizerConfig(kind=kind),
                                       None, "meta")
            assert _port_placements(grid, dims, meta, rules) == \
                _jax_placements(mesh, dims, struct, rules), (arch, kind)
        dec, dec_dims = M.decode_state_specs(cfg, LM_SHAPES["decode_32k"])
        assert _port_placements(grid, dec_dims, dec, rules) == \
            _jax_placements(mesh, jdec_dims, jdec, rules), arch
        for name, s in LM_SHAPES.items():
            batch = M.input_specs(cfg, s)
            dims = M.batch_logical_dims(cfg, s)
            assert _port_placements(grid, dims, batch, rules) == \
                _jax_placements(mesh, dims, JM.input_specs(
                    jcfg, JSHAPES[name]), rules), (arch, name)


def test_rules_equal_the_reference():
    assert SH.DEFAULT_RULES == JSH.DEFAULT_RULES
    assert SH.FSDP_RULES == JSH.FSDP_RULES
    assert mesh_lib.production_layout() == mesh_lib.Layout(
        (16, 16), ("data", "model"))
    assert mesh_lib.production_layout(multi_pod=True).shape == (2, 16, 16)
    assert mesh_lib.data_axes(mesh_lib.production_layout(True)) == \
        ("pod", "data")


_POD = ((2, 16, 16), ("pod", "data", "model"))
# (layout, dims, shape, rules, the placement tests/test_sharding.py wants)
CASES = {
    "basic": (_POD, ("embed", "heads", "head"), (2560, 32, 128), None,
              (None, "model", None)),
    "batch_uses_pod_and_data": (_POD, ("batch", "seq"), (256, 4096), None,
                                (("pod", "data"), None)),
    "llama4_heads_fall_back": (_POD, ("embed", "heads", "head"),
                               (5120, 40, 128), None, (None, None, None)),
    "batch_of_one_falls_back": (_POD, ("batch", None), (1, 1), None,
                                (None, None)),
    "no_axis_reuse": (_POD, ("vocab", "ffn"), (151936, 9728), None,
                      ("model", None)),
    "fsdp_embed_over_data": (_POD, ("embed", "ffn"), (7168, 2048), "fsdp",
                             ("data", "model")),
    "fsdp_ffn_indivisible": (_POD, (None, "ffn"), (4, 24), "fsdp",
                             (None, None)),
    "fsdp_ffn_primary": (_POD, (None, "ffn"), (4, 32), "fsdp",
                         (None, "model")),
    "single_pod": (((16, 16), ("data", "model")), ("batch", "seq"),
                   (256, 4096), None, ("data", None)),
    "tree_leaf_w": (((4, 2), ("data", "model")), ("embed", "ffn"), (8, 6),
                    None, (None, "model")),
    "tree_leaf_b": (((4, 2), ("data", "model")), (None,), (3,), None,
                    (None,)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_reference_sharding_cases(name):
    """``tests/test_sharding.py``'s resolutions: the port's placement is
    the expected one and the reference's, on a layout and on a grid of
    the same shape (resolve_tree for the tree cases)."""
    (shape, axes), dims, size, rules, want = CASES[name]
    port_rules = SH.FSDP_RULES if rules == "fsdp" else None
    jax_rules = JSH.FSDP_RULES if rules == "fsdp" else None
    got = SH.resolve_spec(mesh_lib.Layout(shape, axes), dims, size,
                          port_rules)
    grid = mesh_lib.DeviceGrid(shape, axes, 0, torch.device("cpu"))
    assert got == want == SH.resolve_spec(grid, dims, size, port_rules)
    assert tuple(JSH.resolve_spec(abstract_mesh(shape, axes), dims, size,
                                  jax_rules)) == want
    leaf = {"w": torch.empty(size, device="meta")}
    assert SH.resolve_tree(grid, {"w": dims}, leaf, port_rules)["w"] == want
    assert SH.resolve_tree(grid, {"w": None}, leaf)["w"] == ()


def test_shard_hint_checks_rows_and_is_the_identity():
    """Outside a context the hint returns its input unchecked; inside one
    it returns it when the rows are where the reference puts them, and
    raises when they are not (whole rows of a batch the rules split over
    "data"; rows split over (data, model) where the rules use "data")."""
    x = torch.ones(4, 4)
    assert SH.shard_hint(x, ("batch", "embed")) is x
    grid = mesh_lib.DeviceGrid((2, 2), ("data", "model"), 0,
                               torch.device("cpu"))
    with SH.activation_sharding(grid, None, ("data",)):
        assert SH.shard_hint(x, ("batch", "seq")) is x
        assert SH.shard_hint(x, ("embed", "seq")) is x
        assert SH.current_mesh_and_rules()[0] is grid
    with SH.activation_sharding(grid, None, ()):
        y = torch.ones(3, 4)      # 3 rows divide no axis: held whole
        assert SH.shard_hint(y, ("batch", "seq")) is y
        with pytest.raises(ValueError, match="places its batch"):
            SH.shard_hint(x, ("batch", "seq"))
    with SH.activation_sharding(grid, None, ("data", "model")):
        with pytest.raises(ValueError, match="places its batch"):
            SH.shard_hint(x, ("batch", "seq"))
    assert SH.current_mesh_and_rules() == (None, None)
    assert SH.current_batch_axes() == ()


def test_batch_rows_follow_the_microbatches():
    """Microbatch i is rows [i B/m, (i+1) B/m); rank (d, m) takes block d
    of each over "data" (replicas along "model"); with the batch over
    (data, model) every rank has its own rows, and a microbatch that the
    grid does not divide falls back as the rules do."""
    rules = SH.DEFAULT_RULES
    over_model = dict(rules, batch=(("data", "model"), ("data",)))

    def rows(rank, rules_, m, b=8):
        grid = mesh_lib.DeviceGrid((2, 2), ("data", "model"), rank,
                                   torch.device("cpu"))
        return SH.batch_rows(grid, rules_, b, m)

    assert rows(0, rules, 1) == (("data",), [0, 1, 2, 3])
    assert rows(1, rules, 1) == (("data",), [0, 1, 2, 3])
    assert rows(2, rules, 2) == (("data",), [2, 3, 6, 7])
    assert rows(3, over_model, 2) == (("data", "model"), [3, 7])
    assert rows(1, over_model, 4) == (("data",), [0, 2, 4, 6])
    assert rows(3, rules, 1, b=1) == ((), [0])


# ---------------------------------------------------------------------------
# gathers over the placement's own rings
# ---------------------------------------------------------------------------

GATHER_PLACEMENTS = [("data", None), (None, "model"), ("model", "data"),
                     (("data", "model"), None), (None, None)]
GATHER_SHAPE = (8, 12)


def _gather_body():
    """Every placement's blocks gathered on every rank (and on rank 0
    alone, ``dst=0``), against the global tensor; this rank's records."""
    import dataclasses
    grid = dataclasses.replace(
        mesh_lib.make_grid((2, 2), ("data", "model"), "cpu"), records=[])
    full = torch.arange(96, dtype=torch.float32).reshape(GATHER_SHAPE)
    ok = []
    for p in GATHER_PLACEMENTS:
        blk = grid.local_block(full, p)
        whole = grid.gather(blk, p)
        ok.append(torch.equal(whole, full) and whole is not blk)
        at0 = grid.gather(blk, p, dst=0)
        ok.append(torch.equal(at0, full) if grid.rank == 0 else at0 is None)
    return ok, list(grid.records)


def test_gather_is_ring_by_ring_on_gloo_ranks():
    """On 4 gloo ranks of a 2 x 2 grid, ``DeviceGrid.gather`` returns the
    global tensor of each placement (a dim over "data", over "model", over
    both, over the pair, none) on every rank, and with ``dst=0`` on rank
    0; rank 0's records are a rankless rank's, one all-gather over each
    split dim's own ring (the whole grid only for the ``dst`` form)."""
    ok, real = mesh_lib.run_ranks(_gather_body, 4)
    assert all(ok)
    grid = mesh_lib.rankless_grid(mesh_lib.Layout((2, 2), ("data",
                                                          "model")), 0)
    for p in GATHER_PLACEMENTS:
        blk = torch.empty(grid.local_block(
            torch.empty(GATHER_SHAPE, device="meta"), p).shape,
            device="meta")
        grid.gather(blk, p)
        grid.gather(blk, p, dst=0)
    assert real == grid.records
    every = (0, 1, 2, 3)
    assert [r.ranks for r in real] == [
        (0, 2), every, (0, 1), every, (0, 1), (0, 2), every, every, every,
        every]


def test_gather_wire_is_the_rings():
    """A rankless rank of 16 x 16 records the gather of a block placed over
    "model" alone as one all-gather over its 16-rank model ring: 15/16 of
    the tensor on the wire, where one gather over the whole grid sent
    255/256 of 16 copies of it."""
    grid = mesh_lib.rankless_grid(mesh_lib.production_layout(), 0)
    blk = torch.empty(64, 1024, device="meta")
    full = grid.gather(blk, ("model", None))
    assert tuple(full.shape) == (1024, 1024)
    (rec,) = grid.records
    assert rec.kind == "all-gather"
    assert rec.ranks == tuple(range(16))
    assert rec.wire_bytes == 15 / 16 * 1024 * 1024 * 4
    grid.gather(blk, ("model", None), dst=0)
    assert grid.records[-1].wire_bytes == 255 / 256 * 256 * 64 * 1024 * 4


SCATTER_AXES = [("data",), ("model",), ("data", "model"), ("model", "data")]
SCATTER_CASES = [(a, d) for a in SCATTER_AXES for d in (0, 1)]
SCATTER_IDS = [f"{'-'.join(a)}-dim{d}" for a, d in SCATTER_CASES]


def _scatter_calls(grid, x) -> list:
    """Each case's reduce-scatter of ``x`` beside the block of its psum."""
    out = []
    for axes, dim in SCATTER_CASES:
        got = grid.reduce_scatter(x, axes, dim)
        size = x.shape[dim] // grid.axis_size(axes)
        want = grid.psum(x, axes).narrow(dim, grid.axis_index(axes) * size,
                                         size)
        out.append((got, want))
    return out


def _reduce_scatter_body():
    """Every case on this rank (small integers, whose sums are exact):
    each rank's flags summed over the grid, and this rank's records."""
    import dataclasses
    grid = dataclasses.replace(
        mesh_lib.make_grid((2, 2), ("data", "model"), "cpu"), records=[])
    gen = torch.Generator().manual_seed(grid.rank)
    x = torch.randint(-8, 8, GATHER_SHAPE, generator=gen).float()
    ok = torch.tensor([float(torch.equal(got, want) and got.is_contiguous()
                             and not torch.equal(got, x.narrow(
                                 d, 0, got.shape[d])))
                       for (got, want), (_, d) in zip(
                           _scatter_calls(grid, x), SCATTER_CASES)])
    records = list(grid.records)
    return grid.psum(ok).tolist(), records


@pytest.fixture(scope="module")
def scattered():
    return mesh_lib.run_ranks(_reduce_scatter_body, 4)


@pytest.mark.parametrize("case", range(len(SCATTER_CASES)), ids=SCATTER_IDS)
def test_reduce_scatter_is_the_psums_block_on_gloo_ranks(scattered, case):
    """On 4 gloo ranks of a 2 x 2 grid, ``DeviceGrid.reduce_scatter`` over
    each ring (data, model, the pair in both orders: the ring (model,
    data) is ranks [0, 2, 1, 3], not the group's sorted order) along dim
    0 and dim 1 gives every rank the ``axis_index`` block of the ring's
    psum, bitwise and contiguous, and not its own operand's block."""
    agree, _ = scattered
    assert agree[case] == 4


def test_reduce_scatter_records_are_a_rankless_ranks(scattered):
    """Rank 0's records of the reduce-scatters (and the psums beside
    them) equal a rankless rank 0's of the same calls: a reduce-scatter's
    operand is the whole tensor, its result one block."""
    _, real = scattered
    grid = mesh_lib.rankless_grid(mesh_lib.Layout((2, 2), ("data",
                                                          "model")), 0)
    _scatter_calls(grid, torch.empty(GATHER_SHAPE, device="meta"))
    assert real == grid.records
    scatters = [r for r in real if r.kind == "reduce-scatter"]
    assert len(scatters) == len(SCATTER_CASES)
    for r, (axes, _) in zip(scatters, SCATTER_CASES):
        assert r.operand_bytes == 8 * 12 * 4
        assert r.result_bytes == r.operand_bytes // len(r.ranks)
    assert scatters[-1].ranks == (0, 2, 1, 3)


def test_reduce_scatter_wire_is_the_ring():
    """A rankless rank of 16 x 16 records a reduce-scatter over the model
    ring as one collective over its 16 ranks: 15/16 of its operand on the
    wire (an all-reduce of the same tensor sends twice that), the result
    one block."""
    grid = mesh_lib.rankless_grid(mesh_lib.production_layout(), 0)
    g = torch.empty(1024, 1024, device="meta")
    blk = grid.reduce_scatter(g, "model", 1)
    assert tuple(blk.shape) == (1024, 64)
    (rec,) = grid.records
    assert rec.kind == "reduce-scatter"
    assert rec.ranks == tuple(range(16))
    assert rec.operand_bytes == 1024 * 1024 * 4
    assert rec.result_bytes == 1024 * 64 * 4
    assert rec.wire_bytes == 15 / 16 * 1024 * 1024 * 4
    grid.psum(g, "model")
    assert grid.records[-1].wire_bytes == 2 * rec.wire_bytes


@pytest.mark.parametrize("axes", [("model",), ("model", "data")])
def test_rankless_reduce_scatter_is_its_own_block(axes):
    """A rankless rank on a real device (rank 5 of 16 x 16, on the CPU)
    receives its ``axis_index`` block of its own operand, the sum a real
    rank would get had every rank held this one's operand; over (model,
    data) the ring is not in rank order."""
    grid = mesh_lib.rankless_grid(mesh_lib.production_layout(), 5, "cpu")
    n = grid.axis_size(axes)
    x = torch.arange(4 * n * 3, dtype=torch.float32).reshape(4, n * 3)
    got = grid.reduce_scatter(x, axes, 1)
    k = grid.axis_index(axes)
    assert k == (5 if axes == ("model",) else 80)
    assert torch.equal(got, x[:, 3 * k:3 * (k + 1)])
