"""The halo runtime of the port against the JAX package's, on the CPU:
``pyflwdir_torch.parallel``'s ``tiled_*`` functions over 1, 2 and 4 gloo
ranks (meshes (1, 1), (1, 2) and (2, 2); 4 in ``test_torch_halo_4.py``),
spawned as processes
(``tests/torch_halo_worker.py``), against the JAX functions on
``pyflwdir_tpu.parallel.make_mesh(k)`` of the same shape on the virtual CPU
mesh.

Grids: the 15 x 12 ``d8_small``, a seeded 160 x 200 D8 raster with missing
cells (the size of the JAX tests' reference grid), the 16 x 16 serpentine
of ``tests/test_parallel.py`` and its DEMs (a depression and a nodata cell;
the capped fills). Rules: integer results (rank, basins, cell distances,
Strahler) and the fills are bitwise the JAX ones, as are accumulations of
unit and integer-valued data (the JAX package sums float32, the port
float64, both exact there); float accumulations within rtol 1e-4 of the
JAX ones (the JAX tests' rule) and within the float32 rounding of the
port's float64 ``graph.accumulate`` (rtol 2^-24 + n eps64), "coarse"
within a float32 ulp of "iterate"; metric distances rtol 1e-5 and HAND
atol 1e-5 of the JAX ones; the guards raise where the JAX ones do; every
rank returns the same full array.
"""

import collections
import multiprocessing
import os
import time

import numpy as np
import pytest
import torch

from pyflwdir_torch import dem as tdem
from pyflwdir_torch import parallel, runtime
from pyflwdir_torch.codecs import d8 as td8
from pyflwdir_torch.ops import graph as tgraph
from pyflwdir_torch.ops import tile_plan as ttp
from pyflwdir_tpu import dem as jdem
from pyflwdir_tpu import parallel as jparallel
from pyflwdir_tpu.parallel import distributed as jdist
from tests import torch_halo_worker as worker

JOIN_S = 240  # the most a spawned world may take; it is killed past that
_EPS = np.finfo(np.float64).eps


def _serpentine(nrow=16, ncol=16):
    """Boustrophedon rows joined at their ends: the path crosses a column
    split every two rows (``tests/test_parallel.py``)."""
    d8 = np.zeros((nrow, ncol), dtype=np.uint8)
    for r in range(nrow):
        d8[r, :] = 1 if r % 2 == 0 else 16
        if r % 2 == 0:
            d8[r, -1] = 4
        else:
            d8[r, 0] = 4
    d8[-1, 0 if (nrow - 1) % 2 else ncol - 1] = 0
    return d8


def _inputs(d8_small):
    rng = np.random.RandomState(11)
    shape = (160, 200)
    z = rng.rand(*shape) + np.add.outer(np.linspace(2, 0, shape[0]),
                                        np.linspace(2, 0, shape[1]))
    large = tdem.fill_depressions(z)[1]
    large[1, 2:5] = 247
    large[80:82, 100:103] = 247
    ids, pits, _ = td8.from_array(large, dtype=np.int64)
    valid = (ids >= 0).reshape(shape)
    rank = tgraph.rank(torch.as_tensor(ids)).numpy()
    drain = np.zeros(shape, bool)
    drain[::4, ::6] = True
    mask = np.zeros(shape, bool)
    mask[::7, ::5] = True
    smask = np.ones(shape, bool)
    smask[80:84, :] = False
    rng = np.random.RandomState(5)
    dem = rng.rand(24, 32)
    dem += np.add.outer(np.linspace(1, 0, 24), np.linspace(1, 0, 32))
    dem[5:9, 6:11] -= 0.8  # a depression
    dem[2, 3] = -9999.0
    rng = np.random.RandomState(3)
    dem2 = rng.rand(40, 48).astype(np.float32)
    dem2 += np.add.outer(np.linspace(1, 0, 40), np.linspace(1, 0, 48)).astype(np.float32)
    dem2[10:14, 12:17] -= 0.8  # a deep depression
    rng = np.random.RandomState(9)
    return {
        "small": d8_small, "large": large, "serp": _serpentine(),
        "small.unit": np.ones(d8_small.shape, np.float32),
        "small.pits": td8.from_array(d8_small)[1],
        "serp.unit": np.ones((16, 16), np.float32),
        "large.unit": np.ones(shape, np.float32),
        "large.int": rng.randint(0, 5, shape).astype(np.float32),
        "large.rand": rng.rand(*shape).astype(np.float32),
        "large.pits_some": pits[::2], "large.ids_some": 100 + np.arange(pits[::2].size),
        "large.elev": (rank.astype(np.float32) + 1.0).reshape(shape),
        "large.drain": drain & valid, "large.mask": mask, "large.smask": smask,
        "dem": dem, "dem2": dem2, "dem2.pits": np.array([0, 47, 30 * 48 + 20]),
    }


def _spawn(worlds, out_dirs):
    """Start every world's ranks at once; returns the processes."""
    ctx = multiprocessing.get_context("spawn")
    procs = []
    for world, out_dir in zip(worlds, out_dirs):
        rdv = os.path.join(out_dir, "rendezvous")
        for rank in range(world):
            p = ctx.Process(target=worker.run, args=(rank, world, rdv, out_dir), daemon=True)
            p.start()
            procs.append((world, rank, p))
    return procs


def _join(procs):
    """Wait for every rank, killing all of them past ``JOIN_S`` seconds."""
    deadline = time.monotonic() + JOIN_S
    for world, rank, p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    late = [(w, r) for w, r, p in procs if p.is_alive()]
    for _, _, p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not late, f"ranks (world, rank) {late} did not finish in {JOIN_S} s"
    bad = [(w, r, p.exitcode) for w, r, p in procs if p.exitcode != 0]
    assert not bad, f"ranks (world, rank, exit code) failed: {bad}"


def _jax_run(inp, k):
    """The JAX functions on a k-device mesh: each case's array, or the
    message of the RuntimeError it raised."""
    mesh = jparallel.make_mesh(k)
    out = {}
    for name, (fn, args, kw) in worker.cases(jparallel, inp).items():
        try:
            out[name] = np.asarray(fn(*args, mesh, **kw))
        except RuntimeError as e:
            out[name + ".raised"] = str(e)
    return out


def halo_fixtures(worlds):
    """The module fixtures ``halo`` (the inputs, the spawned ranks' results
    and the JAX references of the world sizes ``worlds``) and ``world`` (each
    of them). World sizes 1 and 2 run here, 4 in ``test_torch_halo_4.py``:
    parallel workers share them out."""

    def halo(tmp_path_factory, d8_small):
        inp = _inputs(d8_small)
        out_dirs = [str(tmp_path_factory.mktemp(f"halo{w}")) for w in worlds]
        for d in out_dirs:
            np.savez(os.path.join(d, "inputs.npz"), **inp)
        procs = _spawn(worlds, out_dirs)
        try:
            jax_ref = {k: _jax_run(inp, k) for k in worlds}  # meanwhile
        finally:
            _join(procs)
        ranks = {w: [dict(np.load(os.path.join(d, f"rank{r}.npz"))) for r in range(w)]
                 for w, d in zip(worlds, out_dirs)}
        return dict(inp=inp, ranks=ranks, jax=jax_ref)

    return (pytest.fixture(scope="module", name="halo")(halo),
            pytest.fixture(scope="module", name="world", params=worlds)(
                lambda request: request.param))


halo, world = halo_fixtures((1, 2))


CASES = sorted(worker.cases(parallel, collections.defaultdict(type(None))))


def _got(halo, world, case):
    """Rank 0's result (the array, or ``(None, message)`` where it raised),
    after checking every rank returned the same."""
    ranks = halo["ranks"][world]
    key = case if case in ranks[0] else case + ".raised"
    for r in range(1, world):
        assert np.array_equal(ranks[r][key], ranks[0][key]), f"rank {r} differs from rank 0"
    if key.endswith(".raised"):
        return None, str(ranks[0][key])
    return ranks[0][key], None


@pytest.mark.parametrize("case", CASES)
def test_halo_matches_jax(halo, world, case):
    got, raised = _got(halo, world, case)
    jx = halo["jax"][world]
    if case + ".raised" in jx:
        assert raised is not None and "did not converge" in raised, (raised, jx[case + ".raised"])
        return
    assert raised is None, raised
    want = jx[case]
    assert got.shape == want.shape and got.dtype == want.dtype
    if case == "sd.m":
        np.testing.assert_allclose(got, want, rtol=1e-5)
    elif case == "hand":
        np.testing.assert_allclose(got, want, atol=1e-5)
    elif case.startswith("acc.") and case.endswith(".rand"):
        np.testing.assert_allclose(got, want, rtol=1e-4)
    else:  # integers, exact float sums, fills: bitwise
        assert np.array_equal(got, want)


def test_guards_fire_where_the_jax_ones_do(halo, world):
    """The serpentine needs many rounds across a column split: with
    ``max_rounds=2`` the guards raise on meshes that split it, as the JAX
    ones do, and on one rank they converge at once."""
    for case in ("rank.serp.guard", "acc.serp.iterate.guard"):
        _, raised = _got(halo, world, case)
        assert (raised is not None) == (world > 1), (case, raised)
        assert (case + ".raised" in halo["jax"][world]) == (world > 1)
    rank, _ = _got(halo, world, "rank.serp")
    ids = td8.from_array(halo["inp"]["serp"], dtype=np.int64)[0]
    assert np.array_equal(rank.ravel(), tgraph.rank(torch.as_tensor(ids)).numpy())


def test_exit_slot_overflow_raises(halo, world):
    """A block with more exit cells than slots raises on every rank (one rank
    has no exit cells)."""
    ranks = halo["ranks"][world]
    for res in ranks:
        assert ("overflow.raised" in res) == (world > 1)
        if world > 1:
            assert "exit cells exceed K slots" in str(res["overflow.raised"])


@pytest.mark.parametrize("data", worker.ACC_DATA)
def test_accumulate_rules(halo, world, data):
    """Coarse within a float32 ulp of iterate (bitwise on integer data), and
    both within the float32 rounding of the port's float64 accumulation."""
    inp = halo["inp"]
    coarse, _ = _got(halo, world, f"acc.large.coarse.{data}")
    iterate, _ = _got(halo, world, f"acc.large.iterate.{data}")
    ids = td8.from_array(inp["large"], dtype=np.int64)[0]
    x = inp[f"large.{data}"]
    want = tgraph.accumulate(torch.as_tensor(ids), torch.as_tensor(x.ravel().astype(np.float64)))
    want = want.numpy().reshape(x.shape)
    rtol = 2.0 ** -24 + ids.size * _EPS
    for got in (coarse, iterate):
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0)
    if data == "rand":
        np.testing.assert_allclose(coarse, iterate, rtol=2.0 ** -23, atol=0)
    else:
        assert np.array_equal(coarse, iterate)
        assert np.array_equal(coarse, want.astype(np.float32))


def test_fill_matches_host(halo, world):
    """The JAX test's rules: the fill within allclose of the host priority
    flood; the capped fills within atol 1e-6 of ``fill_depressions_dev``."""
    from pyflwdir_torch.ops.fill import fill_depressions_dev

    inp = halo["inp"]
    got, _ = _got(halo, world, "fill")
    assert np.allclose(got, jdem.fill_depressions(inp["dem"], nodata=-9999.0)[0])
    for case, kw in (("fill.depth", dict(max_depth=0.3)), ("fill.elv_max", dict(elv_max=1.5))):
        got, _ = _got(halo, world, case)
        want = fill_depressions_dev(inp["dem2"], device="cpu", **kw).numpy()
        assert np.allclose(got, want, atol=1e-6)
    assert int(halo["ranks"][world][0]["fill.depth.rounds"]) >= 1


def test_strahler_matches_native(halo, world):
    """Strahler order against the native sequential sweep, as the JAX test
    holds it; masked: inside the mask, 0 outside."""
    inp = halo["inp"]
    ids = td8.from_array(inp["large"], dtype=np.int64)[0]
    pre = runtime.dfs_preorder(ids)[0]
    valid = (ids >= 0).reshape(inp["large"].shape)
    got, _ = _got(halo, world, "strahler")
    want = runtime.strahler_order(ids, pre).reshape(valid.shape)
    assert np.array_equal(got[valid], want[valid])
    mask = inp["large.smask"]
    got, _ = _got(halo, world, "strahler.mask")
    want = runtime.strahler_order(ids, pre, mask=mask.ravel()).reshape(valid.shape)
    assert np.array_equal(got[valid & mask], want[valid & mask]) and got[~mask].max() == 0
    # each level raises an order by at most one
    assert int(halo["ranks"][world][0]["rounds.strahler"]) >= int(got.max()) - 1


def test_mesh_layout(halo, world):
    shapes = {1: (1, 1), 2: (1, 2), 4: (2, 2)}
    for res in halo["ranks"][world]:
        assert tuple(res["mesh_shape"]) == shapes[world]
    assert jparallel.make_mesh(world).devices.shape == shapes[world]


def test_child_counts_match_the_jax_stencil():
    """The device child count ``tiled_strahler`` uses is the JAX package's
    numpy stencil's, bitwise, on a raster with every D8 code (pits, nodata,
    steps off the grid and into nodata) and on a mask."""
    from pyflwdir_torch.codecs import d8 as d8c
    from pyflwdir_torch.ops import order as tord
    from pyflwdir_tpu.parallel import tiled as jtiled

    rng = np.random.RandomState(8)
    codes = np.array([0, 1, 2, 4, 8, 16, 32, 64, 128, 255, 247], np.uint8)
    codes = codes[rng.randint(0, codes.size, (37, 41))]
    valid = (d8c._DR_LUT[codes] != 0) | (d8c._DC_LUT[codes] != 0) | np.isin(codes, d8c._pv)
    for member_mask in (None, rng.rand(*codes.shape) < 0.7):
        member, tgt = tord._d8_targets(codes, member_mask, device="cpu")
        want_member = valid if member_mask is None else valid & member_mask
        assert np.array_equal(member.numpy().reshape(codes.shape), want_member)
        got = tord._child_counts(member, tgt).numpy().reshape(codes.shape)
        assert np.array_equal(got, jtiled._child_counts(codes, want_member))


def test_scaling_model_is_the_jax_formula():
    """``scaling_model`` on a port plan is the JAX package's formula fed the
    port's byte counts (the int16 upward tables, the int32 exits), at the
    H100's rates by default."""
    from pyflwdir_torch.parallel import distributed as tdist

    rng = np.random.RandomState(1)
    z = rng.rand(384, 512) + np.add.outer(np.linspace(2, 0, 384), np.linspace(2, 0, 512))
    ids = td8.from_array(tdem.fill_depressions(z)[1], dtype=np.int64)[0]
    tp = ttp.build_tile_plan(ids, (384, 512), device="cpu")
    tab = sum(np.asarray(tp.idx[k]).size * 2 for k in tdist._UP_TABLES)
    assert tab == sum(int(v.numel()) * 2 for k, v in tp.idx_t.items() if k in tdist._UP_TABLES)
    assert all(tp.idx_t[k].dtype == torch.int16 for k in tdist._UP_TABLES)

    class Fed:  # the JAX plan's interface, carrying the port's byte counts
        _tabs_np = {"port": np.empty(tab, np.uint8)}
        pshape, n_exit_flat, grid = tp.pshape, tp.n_exit_flat, tp.grid

        @staticmethod
        def _keys(p):
            return ["port"] if p == "a" else []

    for k in (1, 2, 4, 8):
        for scale in (1.0, 64.0):
            got = tdist.scaling_model(tp, k, cells_scale=scale)
            want = jdist.scaling_model(Fed, k, hbm_gbps=3350.0, ici_gbps=450.0,
                                       cells_scale=scale)
            for key, v in want.items():
                if key != "assumptions":
                    assert got[key] == pytest.approx(v, rel=1e-12), key
            assert got["assumptions"]["hbm_gbps_per_chip"] == 3350.0
            assert got["assumptions"]["ici_gbps_per_link"] == 450.0


def test_dryrun_multichip_one_rank(tmp_path):
    """``entry.dryrun_multichip(1)`` on the CPU: every sharded function
    validated against the one-device ones, the report written where asked."""
    import json

    from pyflwdir_torch import entry

    path = tmp_path / "scaling.json"
    entry.dryrun_multichip(1, report_path=str(path), device="cpu")
    rep = json.loads(path.read_text())
    assert rep["device"]["type"] == "cpu" and rep["validated"]
    assert set(rep["comm_model"]) == {"2", "4", "8"}
    assert rep["strong_scaling"]["1"]["efficiency"] == pytest.approx(1.0)
