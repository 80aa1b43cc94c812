"""The port's call forms against the JAX package's, on the CPU.

``inspect.signature`` of every public function, class and method of every
module of ``pyflwdir_tpu`` against its counterpart in ``pyflwdir_torch``: the
same parameters in the same order, of the same kinds and with the same
defaults. The port may add one thing, a trailing ``device`` parameter
(before a trailing ``**kwargs``), and differs on purpose only where
``ROADMAP.md`` (Queue 3) says so: the routers are built from one
permutation (``RouterPlan(sigma)``, ``RouterPlanBig(sigma)``),
``scaling_model`` defaults to the H100's rates and
``make_mesh`` takes a torch device type.

Then each form that once differed is called with the JAX argument list on
a small grid and held against the JAX package's result: integers bitwise.
The whole file takes about 32 s alone, in one process on a CPU.
"""

import importlib
import inspect
import pkgutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pyflwdir_torch
import pyflwdir_tpu
from pyflwdir_torch import dem as tdem
from pyflwdir_torch import regions as treg
from pyflwdir_torch import rivers as trv
from pyflwdir_torch.codecs import d8 as td8
from pyflwdir_torch.ops import accel as taccel
from pyflwdir_torch.ops import accel_big as tbig
from pyflwdir_torch.ops import graph as tgraph
from pyflwdir_torch.ops import plan as tplan
from pyflwdir_torch.ops import router_big as trb
from pyflwdir_torch.ops import tile_plan as ttp
from pyflwdir_tpu import dem as jdem
from pyflwdir_tpu import regions as jreg
from pyflwdir_tpu import rivers as jrv
from pyflwdir_tpu.ops import accel as jaccel
from pyflwdir_tpu.ops import accel_big as jbig
from pyflwdir_tpu.ops import graph as jgraph
from pyflwdir_tpu.ops import plan as jplan
from pyflwdir_tpu.ops import router_big as jrb
from pyflwdir_tpu.ops import tile_plan as jtpm

# the on-purpose differences (ROADMAP.md, Queue 3): the routers' sigma
# constructors, the H100 rates of scaling_model, make_mesh's torch device type
_ON_PURPOSE = {
    "ops.router.RouterPlan": "constructor",
    "ops.router_big.RouterPlanBig": "constructor",
    "parallel.distributed.scaling_model": "defaults",
    "parallel.tiled.make_mesh": "device",
}


def _modules(pkg):
    names = {m.name.split(".", 1)[1] for m in pkgutil.walk_packages(pkg.__path__,
                                                                      pkg.__name__ + ".")}
    return sorted(names)


_MODULES = _modules(pyflwdir_tpu)


def _callables(mod):
    """``{dotted name: callable}`` of the public functions and classes that
    ``mod`` defines, a class as its ``__init__`` and its public methods."""
    out = {}
    for name, obj in vars(mod).items():
        if name.startswith("_") or getattr(obj, "__module__", None) != mod.__name__:
            continue
        if inspect.isfunction(obj):
            out[name] = obj
        elif inspect.isclass(obj):
            out[name] = obj.__init__
            for m, v in vars(obj).items():
                if m.startswith("_") or isinstance(v, property):
                    continue
                f = getattr(obj, m)
                if callable(f):
                    out[f"{name}.{m}"] = f
    return out


def _port_callable(mod, name):
    """The port's counterpart of ``name`` (``f``, ``Class`` or
    ``Class.method``) in ``mod``, wherever it is defined; None if missing."""
    obj = mod
    for part in name.split("."):
        obj = getattr(obj, part, None)
        if obj is None:
            return None
    return obj.__init__ if inspect.isclass(obj) else obj


def _params(f):
    return [(p.name, p.kind, repr(p.default)) for p in inspect.signature(f).parameters.values()]


def _same_but_device(pj, pt):
    """``pt`` is ``pj`` with at most a ``device`` parameter added at its end
    (before a trailing ``**kwargs``)."""
    if pt == pj:
        return True
    var_kw = inspect.Parameter.VAR_KEYWORD
    tail_j = pj[-1:] if pj and pj[-1][1] == var_kw else []
    tail_t = pt[-1:] if pt and pt[-1][1] == var_kw else []
    if tail_j != tail_t:
        return False
    body_j, body_t = pj[: len(pj) - len(tail_j)], pt[: len(pt) - len(tail_t)]
    return (len(body_t) == len(body_j) + 1 and body_t[:-1] == body_j
            and body_t[-1][0] == "device" and body_t[-1][2] == "None")


def test_every_module_has_its_port():
    port = set(_modules(pyflwdir_torch))
    assert [m for m in _MODULES if m not in port] == []


@pytest.mark.parametrize("mod", _MODULES)
def test_signatures(mod):
    jm = importlib.import_module(f"pyflwdir_tpu.{mod}")
    tm = importlib.import_module(f"pyflwdir_torch.{mod}")
    faults = []
    for name, fj in _callables(jm).items():
        key = f"{mod}.{name}"
        why = _ON_PURPOSE.get(key)
        if why == "constructor":
            continue
        ft = _port_callable(tm, name)
        if ft is None:
            faults.append(f"{key}: not in the port")
            continue
        pj, pt = _params(fj), _params(ft)
        if why == "defaults":
            pj, pt = [p[:2] for p in pj], [p[:2] for p in pt]
        elif why == "device":
            pj = [("device",) + p[1:] if p[0] == "devices" else p for p in pj]
            pj, pt = [p[:2] for p in pj], [p[:2] for p in pt]
        if not _same_but_device(pj, pt):
            faults.append(f"{key}: JAX {inspect.signature(fj)}, port {inspect.signature(ft)}")
    assert faults == []


def test_on_purpose_list_names_real_callables():
    for key in _ON_PURPOSE:
        mod, name = key.split(".", 1) if key.count(".") == 1 else (
            ".".join(key.split(".")[:2]), ".".join(key.split(".")[2:]))
        assert name in _callables(importlib.import_module(f"pyflwdir_tpu.{mod}")), key


# ---------------------------------------------------------------------------
# the repaired forms, called with the JAX argument lists
# ---------------------------------------------------------------------------
def _demo_d8(shape, seed):
    rng = np.random.RandomState(seed)
    z = rng.rand(*shape)
    z += np.add.outer(np.linspace(2, 0, shape[0]), np.linspace(2, 0, shape[1]))
    return tdem.fill_depressions(z)[1]


@pytest.fixture(scope="module")
def grid():
    d8 = _demo_d8((96, 160), 11)
    j = pyflwdir_tpu.from_array(d8)
    t = pyflwdir_torch.from_array(d8, device="cpu")
    ids = td8.from_array(d8, dtype=np.int64)[0]
    return dict(d8=d8, j=j, t=t, ids=ids, rank=np.asarray(j.rank).ravel())


def test_region_outlets_takes_rank(grid):
    j, t = grid["j"], grid["t"]
    bas = np.asarray(j.basins()).reshape(j.shape)
    got = treg.region_outlets(bas, t.idxs_ds, grid["rank"], device="cpu")
    want = jreg.region_outlets(bas, j.idxs_ds, grid["rank"])
    assert all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(got, want))


def test_snap_takes_and_ignores_extra_keywords(grid):
    j, t = grid["j"], grid["t"]
    idxs = np.arange(0, grid["ids"].size, 97)
    mask = np.asarray(j.upstream_area("cell")).reshape(j.shape) > 30
    got = t.snap(idxs, mask=mask, unit="m")
    want = j.snap(idxs, mask=mask, unit="m")
    assert np.array_equal(np.asarray(got[0]), np.asarray(want[0]))
    assert np.array_equal(np.asarray(got[1]), np.asarray(want[1]))


def test_plans_take_fast_and_the_graph(grid):
    ids = grid["ids"]
    ones = np.ones(ids.size, np.float32)
    for fast in (True, False):
        dfs = tplan.build_plan(ids, fast, device="cpu")
        jd = jplan.build_plan(ids, fast)
        assert np.array_equal(dfs.preorder_np, jd.preorder_np)
        d2 = tplan.DfsPlan(dfs.preorder_np, dfs.pos_np, dfs.size_np, fast, device="cpu")
        assert torch.equal(d2.fast(), dfs.end)
    ap = taccel.AccelPlan(dfs, ids, device="cpu")
    jp = jaccel.AccelPlan(jd, ids)
    assert ap.ok == jp.ok
    want = np.asarray(jax.jit(jp.accumulate)(jnp.asarray(ones)))
    assert np.array_equal(ap.accumulate(torch.as_tensor(ones)).numpy(), want)


def test_renamed_keywords(grid):
    j, t, ids, rank = grid["j"], grid["t"], grid["ids"], grid["rank"]
    rng = np.random.RandomState(5)
    z = (rng.rand(*j.shape) * 10 + np.linspace(20, 0, j.shape[0])[:, None]).ravel()
    kw = dict(idxs_ds_np=ids, rank_np=rank)
    assert np.array_equal(tdem.adjust_elevation(elevtn_np=z, **kw),
                          jdem.adjust_elevation(elevtn_np=z, **kw))
    assert np.array_equal(tdem.dig_4connectivity(elv_flat=z, shape=j.shape, **kw),
                          jdem.dig_4connectivity(elv_flat=z, shape=j.shape, **kw))
    assert np.array_equal(tgraph.upstream_matrix(idxs_ds_np=ids),
                          jgraph.upstream_matrix(idxs_ds_np=ids))
    n = ids.size
    args = dict(zs=z, rivdph=np.full(n, 2.0), qbankfull=np.full(n, 50.0),
                rivdst=np.cumsum(np.full(n, 90.0))[::-1].copy(), rivwth=np.full(n, 30.0),
                manning=np.full(n, 0.03), n_iter=1, n_substeps=2)
    assert np.array_equal(trv.rivdph_gvf(**kw, **args), jrv.rivdph_gvf(**kw, **args))


@pytest.mark.parametrize("src_w", [64, 192])
def test_lane_gather_tiled_is_a_function(src_w):
    rng = np.random.RandomState(src_w)
    x2 = rng.randint(-99, 99, (40, src_w)).astype(np.int32)
    idx = rng.randint(0, src_w, (40, 64)).astype(np.int32)
    got = trb.lane_gather_tiled(torch.as_tensor(x2), idx, 256)
    want = np.asarray(jrb.lane_gather_tiled(jnp.asarray(x2), jnp.asarray(idx), 256))
    assert got.shape == idx.shape and np.array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="narrower"):
        trb.lane_gather_tiled(torch.as_tensor(x2[:, :32]), idx)


def test_stage_table_methods_round_trip(grid, tile_plans):
    """The methods that hand out the JAX plans' stage tables, for saving,
    hand out the port's composed indices, which the constructors take back:
    the same indices and sums without composing them again."""
    ids = grid["ids"]
    dfs = tplan.build_plan(ids, False, device="cpu")
    bp = tbig.BigAccelPlan(dfs, ids, device="cpu")
    again = tbig.BigAccelPlan(dfs, ids, routers=bp.router_tables(), device="cpu")
    for k in ("src_in", "near_end", "src_out", "far_end"):
        assert np.array_equal(getattr(again, k), getattr(bp, k)), k
    x = torch.as_tensor(np.random.RandomState(3).randint(0, 9, ids.size).astype(np.int32))
    assert torch.equal(again.accumulate(x), bp.accumulate(x))
    tile_plans["big"].down_arrays()  # builds the coarse level's down indices
    c = tile_plans["big"].coarse
    own = tbig.BigAccelPlan(c.dfs, None, routers=c.router_tables(),
                            in_slot=tile_plans["big"]._coarse_meta["in_slot"],
                            out_slot=tile_plans["big"]._coarse_meta["out_slot"])
    own.build_down(c.dfs, routers=c.down_router_tables())
    pk = torch.as_tensor(np.random.RandomState(7).randint(0, 5, c.n_out).astype(np.int32))
    assert torch.equal(own.accumulate_down(pk), c.accumulate_down(pk))
    xi = torch.as_tensor(np.random.RandomState(8).randint(0, 5, c.n_in).astype(np.int32))
    assert torch.equal(own.accumulate(xi), c.accumulate(xi))
    rp = trb.RouterPlanBig.build(np.arange(1 << 21)[::-1].copy(), device="cpu")
    (sigma,) = rp.tpu_stages()
    assert torch.equal(sigma, rp.sigma)


def test_big_accel_plan_takes_its_tables(grid):
    """``BigAccelPlan(dfs, idxs_ds_np)`` and ``accumulate(data, arrs)``:
    bitwise the JAX DFS plan's sums (the JAX ``BigAccelPlan`` is held to
    them in ``test_torch_accel_big.py``)."""
    ids = grid["ids"]
    tp = tbig.BigAccelPlan(tplan.build_plan(ids, False, device="cpu"), ids, device="cpu")
    x = np.random.RandomState(2).randint(0, 9, ids.size).astype(np.int32)
    want = np.asarray(jplan.accumulate_planned(jplan.build_plan(ids), jnp.asarray(x)))
    got = tp.accumulate(torch.as_tensor(x), tp.arrays())
    assert np.array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def tile_plans():
    d8 = _demo_d8((256, 256), 5)
    ids = td8.from_array(d8, dtype=np.int64)[0]
    jtp = jtpm.build_tile_plan(ids, d8.shape)
    tp = ttp.build_tile_plan(ids, d8.shape, device="cpu")
    old = ttp._COARSE_ROUTER_MIN, ttp._COARSE_SMALL_MAX
    ttp._COARSE_ROUTER_MIN, ttp._COARSE_SMALL_MAX = 1, 0
    try:
        big = ttp.build_tile_plan(ids, d8.shape, device="cpu")
    finally:
        ttp._COARSE_ROUTER_MIN, ttp._COARSE_SMALL_MAX = old
    assert type(big.coarse).__name__ == "BigAccelPlan" and tp.has_entries
    return dict(ids=ids, jtp=jtp, tp=tp, big=big)


def test_tile_plan_takes_its_tables(tile_plans):
    """The flagship call form, ``tp.accumulate(data, tp.arrays())``, and
    ``accumulate_down(data, tp.down_arrays())``: bitwise the JAX plan's."""
    ids, jtp, tp = tile_plans["ids"], tile_plans["jtp"], tile_plans["tp"]
    x = np.random.RandomState(4).randint(0, 5, ids.size).astype(np.int32)
    want = np.asarray(jax.jit(jtp.accumulate)(jnp.asarray(x), jtp.arrays()))
    got = tp.accumulate(torch.as_tensor(x), tp.arrays())
    assert np.array_equal(got.numpy(), want)
    want = np.asarray(jax.jit(jtp.accumulate_down)(jnp.asarray(x), jtp.down_arrays()))
    got = tp.accumulate_down(torch.as_tensor(x), tp.down_arrays())
    assert np.array_equal(got.numpy(), want)


def test_big_coarse_level_takes_its_tables(tile_plans):
    """A ``BigAccelPlan`` coarse level: the tile plan's sweeps on it equal
    the default plan's; its ``accumulate_down(pkf, arrs)`` its own; and
    ``build_down`` of the coarse DFS plan (the JAX call form) equals the JAX
    ``BigAccelPlan`` built in slot mode on the same coarse DFS plan and slot
    maps, bitwise over all ``n_in`` slots of the exit layout, and gives 0
    past them."""
    ids, tp, big = tile_plans["ids"], tile_plans["tp"], tile_plans["big"]
    x = torch.as_tensor(np.random.RandomState(4).randint(0, 5, ids.size).astype(np.int32))
    assert torch.equal(big.accumulate(x, big.arrays()), tp.accumulate(x))
    assert torch.equal(big.accumulate_down(x, big.down_arrays()), tp.accumulate_down(x))
    c, meta = big.coarse, big._coarse_meta
    pk = torch.as_tensor(np.random.RandomState(6).randint(0, 5, c.n_out).astype(np.int32))
    a = c.accumulate_down(pk, c.down_arrays())
    assert torch.equal(a, c.accumulate_down(pk))
    own = tbig.BigAccelPlan(c.dfs, None, in_slot=meta["in_slot"], out_slot=meta["out_slot"])
    own.build_down(c.dfs)
    jd = jplan.DfsPlan(c.dfs.preorder_np, c.dfs.pos_np, c.dfs.size_np, fast=False)
    jb = jbig.BigAccelPlan(jd, None, in_slot=meta["in_slot"], out_slot=meta["out_slot"])
    jb.build_down(jd)
    want = np.asarray(jax.jit(jb.accumulate_down)(jnp.asarray(pk.numpy()), jb.down_arrays()))
    got = own.accumulate_down(pk, own.down_arrays()).numpy()
    assert want.shape == (own.n_in,) and np.count_nonzero(want)
    assert np.array_equal(got[: own.n_in], want)
    assert not np.any(got[own.n_in:])
