"""The port's public surface, module by module: for every module of
``pyflwdir_tpu`` that has a file in ``pyflwdir_torch``, the port module's
public top-level names include the JAX module's (its ``__all__``, else the
public functions and classes it defines). Nothing in the port raises
NotImplementedError: plans of every JAX tile height build and load."""

import importlib
import inspect
import pathlib
import re

import numpy as np
import pytest

import pyflwdir_torch
import pyflwdir_tpu

_JAX_ROOT = pathlib.Path(pyflwdir_tpu.__file__).resolve().parent
_PORT_ROOT = pathlib.Path(pyflwdir_torch.__file__).resolve().parent


def _modules():
    """Dotted names (below the package) of the JAX package's modules that
    have a port file."""
    out = []
    for f in sorted(_JAX_ROOT.rglob("*.py")):
        rel = f.relative_to(_JAX_ROOT)
        if rel.name == "__init__.py":
            rel = rel.parent
        else:
            rel = rel.with_suffix("")
        if rel.parts and ((_PORT_ROOT / rel).with_suffix(".py").exists()
                          or (_PORT_ROOT / rel / "__init__.py").exists()):
            out.append(".".join(rel.parts))
    return out


MODULES = _modules()


def _public(mod):
    names = getattr(mod, "__all__", None)
    if names is not None:
        return set(names)
    return {n for n, v in vars(mod).items() if not n.startswith("_")
            and (inspect.isfunction(v) or inspect.isclass(v)) and v.__module__ == mod.__name__}


def test_the_modules_of_this_slice_have_port_files():
    for name in ("ops.stencil", "parallel.distributed", "parallel.tiled", "gridtools",
                 "ops.router", "runtime", "ops"):
        assert name in MODULES, name
    assert (_PORT_ROOT / "entry.py").exists()
    from pyflwdir_torch import entry

    assert {"entry", "dryrun_multichip"} <= set(entry.__all__)


@pytest.mark.parametrize("name", MODULES)
def test_public_names_include_the_jax_module(name):
    jmod = importlib.import_module(f"pyflwdir_tpu.{name}")
    tmod = importlib.import_module(f"pyflwdir_torch.{name}")
    missing = sorted(n for n in _public(jmod) if not hasattr(tmod, n))
    assert not missing, missing


def test_only_tall_tiles_raise_not_implemented():
    """No site of the port raises NotImplementedError (the last two, for
    tiles taller than 128 rows, are gone): ``build_sharded_plan`` and a
    plan's configuration take 128 to 512 rows, as the JAX package's do, and
    raise its ValueError for another height."""
    from pyflwdir_torch import parallel
    from pyflwdir_torch.ops.tile_plan import TilePlan
    from pyflwdir_tpu.ops.tile_plan import TilePlan as JTilePlan

    sites = []
    for f in sorted(_PORT_ROOT.rglob("*.py")):
        sites += [(f.name, m.start()) for m in re.finditer(r"raise NotImplementedError",
                                                          f.read_text())]
    assert sites == [], sites
    mesh = parallel.make_mesh(device="cpu")
    codes = np.zeros((8, 8), np.uint8)
    tp, pshape = parallel.build_sharded_plan(codes, mesh, tile_rows=256)
    assert tuple(pshape) == (256, 128) and tp.Y == 256 and tp.NT == 1
    cfg = dict(shape=(600, 300), far_mode=None, b=1, R_pad=128, E_pad=0, F_rows=0,
               has_far=False, has_entries=False)
    for rows in (128, 256, 384, 512):
        tp = TilePlan.__new__(TilePlan)
        tp._config(dict(cfg, tile_rows=rows), "cpu")
        assert (tp.Y, tp.G, tp.grid) == (rows, rows // 128, (-(-600 // rows), 3))
    for rows in (64, 200, 640):
        tp = TilePlan.__new__(TilePlan)
        with pytest.raises(ValueError, match="multiple of 128") as err:
            tp._config(dict(cfg, tile_rows=rows), "cpu")
        with pytest.raises(ValueError) as jerr:
            JTilePlan(np.full(600 * 300, -1), (600, 300), tile_rows=rows)
        assert str(err.value) == str(jerr.value)


def test_parallel_runs_every_jax_function():
    """Every name of the JAX ``parallel.__all__``, and every
    ``tiled_accumulate`` method, runs on the CPU mesh."""
    from pyflwdir_torch import parallel
    from pyflwdir_tpu import parallel as jparallel

    assert set(jparallel.__all__) <= set(parallel.__all__)
    rng = np.random.RandomState(0)
    z = rng.rand(20, 24) + np.add.outer(np.linspace(1, 0, 20), np.linspace(1, 0, 24))
    from pyflwdir_torch import dem

    d8 = dem.fill_depressions(z)[1]
    mesh = parallel.make_mesh(device="cpu")
    outs = [parallel.tiled_accumulate(d8, np.ones(d8.shape), mesh, method=m)
            for m in ("coarse", "iterate", "plan")]
    assert all(np.array_equal(o, outs[0]) for o in outs)
    pits = np.flatnonzero(np.isin(d8.ravel(), (0, 255)))
    for out in (parallel.tiled_rank(d8, mesh), parallel.tiled_basins(d8, pits, mesh),
                parallel.tiled_stream_distance(d8, mesh), parallel.tiled_hand(d8, z, d8 == 0, mesh),
                parallel.tiled_strahler(d8, mesh), parallel.tiled_fill(z, mesh)):
        assert out.shape == d8.shape
