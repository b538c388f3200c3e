"""The field-view DSL on four gloo ranks (a 2x2 mesh) on the CPU:
``gt4py_tpu_torch.next.distributed`` held to the JAX package's
``gt4py_tpu.next.distributed`` and its oracle (the global view of
tests/parallel/test_next_distributed.py, and ``shard_map_operator``)."""

import numpy as np
import pytest

from gt4py_tpu_torch import config
from gt4py_tpu_torch.testing import dist_cases

CASES = {
    "next_distribute": dict(),
    "next_lap": dict(),
    "next_scan": dict(),
    "next_refusals": dict(),
    "next_replicate": dict(),
    "wide": dict(case="next_shard_map", op="wide"),
    "gradx_open": dict(case="next_shard_map", op="gradx", periodic=False),
    "two": dict(case="next_shard_map", op="two", w=3.0),
    "lap_periodic": dict(case="next_shard_map", op="lap", seed=7),
    "derivatives_global": dict(case="next_derivatives", mode="global"),
    "derivatives_shard_map": dict(case="next_derivatives", mode="shard_map"),
}


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    monkeypatch.setattr(config, "DEFAULT_DEVICE", "cpu")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return dist_cases.launch(CASES, workdir=str(tmp_path_factory.mktemp("ranks")))


def result(ranks, name, rank=0):
    for status, res in ranks[name]:
        assert status == "ok", res
    return ranks[name][rank][1]


@pytest.fixture(scope="module")
def jax_ops():
    """The JAX package's operators of ``dist_cases.next_ops``."""
    import gt4py_tpu.next as gtx
    from gt4py_tpu.next import Dims, Field

    I = gtx.Dimension("I")  # noqa: E741
    J = gtx.Dimension("J")
    K = gtx.Dimension("K", kind=gtx.DimensionKind.VERTICAL)
    Ioff = gtx.FieldOffset("Ioff", source=I, target=(I,))
    Joff = gtx.FieldOffset("Joff", source=J, target=(J,))
    F2 = Field[Dims[I, J], gtx.float64]

    @gtx.field_operator
    def lap(f: F2) -> F2:
        return f(Ioff[1]) + f(Ioff[-1]) + f(Joff[1]) + f(Joff[-1]) - 4.0 * f

    @gtx.field_operator
    def wide(f: F2, g: F2) -> F2:
        return f(Ioff[2]) + f(Ioff[-1]) + g(Joff[1]) + g(Joff[-2]) - 4.0 * f

    @gtx.field_operator
    def gradx(f: F2) -> F2:
        return f(Ioff[1]) - f

    @gtx.field_operator
    def two(f: F2, w: gtx.float64) -> tuple[F2, F2]:
        g = f(Ioff[1]) - f
        return w * g, g * g

    return dict(gtx=gtx, I=I, J=J, K=K, lap=lap, wide=wide, gradx=gradx, two=two)


@pytest.fixture(scope="module")
def jmesh():
    from gt4py_tpu.parallel import CartesianMesh

    return CartesianMesh((2, 2))


def test_distribute_places_and_preserves_domain(ranks):
    got = [result(ranks, "next_distribute", r) for r in range(4)]
    data = np.random.default_rng(0).random((16, 32))
    for g in got:
        assert g["same_domain"] and g["block"] == (8, 16)
        assert not g["replicated"] and g["dim_map"] == {"I": "x", "J": "y"}
        assert g["ranges"] == [(0, 16), (0, 32)]
    np.testing.assert_array_equal(got[0]["gathered"], data)


def test_operator_on_sharded_fields_matches_oracle(ranks, jax_ops, jmesh):
    """``lap`` on sharded fields: the JAX package's GSPMD result and its
    oracle's, domain shrunk at the global edges included, bit for bit."""
    import jax

    from gt4py_tpu.next import distributed as jnxd

    o = jax_ops
    data = np.random.default_rng(1).random((16, 32))
    ref = o["lap"](o["gtx"].as_field((o["I"], o["J"]), data, allocator="numpy"))
    f = jnxd.distribute(o["gtx"].as_field((o["I"], o["J"]), data), jmesh, {o["I"]: "x",
                                                                           o["J"]: "y"})
    spmd = np.asarray(jax.jit(lambda g: o["lap"](g).data)(f))
    got = result(ranks, "next_lap")
    assert got["ranges"] == [(r.start, r.stop) for r in ref.domain.ranges] == [(1, 15), (1, 31)]
    np.testing.assert_array_equal(got["values"], ref.asnumpy())
    np.testing.assert_array_equal(got["values"], spmd)
    assert not got["replicated"]


def test_scan_on_sharded_columns(ranks):
    data = np.random.default_rng(3).random((8, 16, 5))
    np.testing.assert_allclose(result(ranks, "next_scan"), np.cumsum(data, axis=2), rtol=1e-15)


@pytest.mark.parametrize("key,match", [("vertical", "vertical"), ("uneven", "divide evenly"),
                                       ("unknown_axis", "unknown mesh axis")])
def test_placement_refusals(ranks, jax_ops, jmesh, key, match):
    """The placements ``field_sharding`` refuses raise ``ValueError`` with
    the JAX package's messages."""
    from gt4py_tpu.next import distributed as jnxd

    got = result(ranks, "next_refusals")[key]
    assert got is not None and match in got
    o = jax_ops
    field, dim_map = {
        "vertical": (o["gtx"].as_field((o["K"],), np.arange(8.0)), {o["K"]: "x"}),
        "uneven": (o["gtx"].as_field((o["I"], o["J"]), np.zeros((15, 32))),
                   {o["I"]: "x", o["J"]: "y"}),
        "unknown_axis": (o["gtx"].as_field((o["I"], o["J"]), np.zeros((16, 32))),
                         {o["I"]: "z"}),
    }[key]
    with pytest.raises(ValueError, match=match):
        jnxd.distribute(field, jmesh, dim_map)


def test_replicated_connectivity(ranks):
    nv = 16
    table = np.stack([(np.arange(nv) + 1) % nv, (np.arange(nv) - 1) % nv], axis=1)
    vals = np.random.default_rng(4).random(nv)
    for r in range(4):
        got = result(ranks, "next_replicate", r)
        assert got["conn"] and got["mask"] and got["device"] == "cpu"
        np.testing.assert_array_equal(got["sum"], vals[table].sum(axis=1))


def _jax_shard_map(o, jmesh, op, periodic, *args, **kw):
    from gt4py_tpu.next.distributed import shard_map_operator

    fields = [o["gtx"].as_field((o["I"], o["J"]), a) for a in args]
    out = shard_map_operator(o[op], jmesh, {o["I"]: "x", o["J"]: "y"}, periodic=periodic)(
        *fields, **kw)
    return [np.asarray(x.data) for x in (out if isinstance(out, tuple) else (out,))]


@pytest.mark.parametrize("name", ["wide", "gradx_open", "two", "lap_periodic"])
def test_shard_map_operator_matches_jax(ranks, jax_ops, jmesh, name):
    """``shard_map_operator``: halos from the operator's extents, periodic
    rings and open zero edges, scalars and tuple outputs, bit for bit
    against the JAX package's."""
    p = CASES[name]
    rng = np.random.default_rng(p.get("seed", 11))
    a, b = rng.random((16, 32)), rng.random((16, 32))
    args = (a, b) if p["op"] == "wide" else (a,)
    kw = {"w": p["w"]} if "w" in p else {}
    want = _jax_shard_map(jax_ops, jmesh, p["op"], p.get("periodic", True), *args, **kw)
    got = result(ranks, name)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if name == "gradx_open":
        np.testing.assert_array_equal(got[0][-1], -a[-1])


def test_operator_halo_matches_jax(jax_ops):
    from gt4py_tpu.next.distributed import operator_halo as jax_halo
    from gt4py_tpu_torch.next.distributed import operator_halo

    o = dist_cases.next_ops()
    assert operator_halo(o["wide"], [o["I"], o["J"]]) == {o["I"]: 2, o["J"]: 2}
    got = {d.value: h for d, h in operator_halo(o["wide"], [o["I"], o["J"]]).items()}
    want = {d.value: h for d, h in jax_halo(jax_ops["wide"],
                                            [jax_ops["I"], jax_ops["J"]]).items()}
    assert got == want


def test_data_dependent_offset_rejected():
    import gt4py_tpu_torch.next as gtx
    from gt4py_tpu_torch.next import Dims, Field, as_offset
    from gt4py_tpu_torch.next.distributed import operator_halo

    I = gtx.Dimension("I")  # noqa: E741
    Ioff = gtx.FieldOffset("Ioff", source=I, target=(I,))

    @gtx.field_operator
    def dyn(f: Field[Dims[I], gtx.float64], idx: Field[Dims[I], gtx.int64]
            ) -> Field[Dims[I], gtx.float64]:
        return f(as_offset(Ioff, idx))

    with pytest.raises(ValueError, match="data-dependent"):
        operator_halo(dyn, [I])


@pytest.mark.parametrize("mode", ["global", "shard_map"])
def test_sharded_operator_derivatives_match_jax(ranks, jax_ops, mode):
    """The gradient (autograd) and the tangent (forward AD) of ``wide`` on
    sharded fields -- called on ``ShardedField``s, and through the
    periodic ``shard_map_operator`` -- gathered, equal ``jax.grad`` and
    ``jax.jvp`` of the JAX package's operator on one device (for the
    periodic one: on the inputs wrapped by the halo, restricted to the
    domain): the exchange carries the tangents and transposes the
    cotangents."""
    import jax
    import jax.numpy as jnp

    o = jax_ops
    gtx, I, J = o["gtx"], o["I"], o["J"]
    rng = np.random.default_rng(13)
    a, b, ta, tb = (jnp.asarray(rng.random((16, 32))) for _ in range(4))

    def out(x, y):
        if mode == "global":
            return o["wide"](gtx.as_field((I, J), x), gtx.as_field((I, J), y)).data
        f = o["wide"](*(gtx.as_field((I, J), jnp.pad(v, 2, mode="wrap"), origin={I: 2, J: 2})
                        for v in (x, y)))
        i0, j0 = (-r.start for r in f.domain.ranges)
        return f.data[i0:i0 + 16, j0:j0 + 32]

    got = result(ranks, f"derivatives_{mode}")
    w = rng.random(tuple(hi - lo for lo, hi in got["ranges"]))
    want = jax.grad(lambda x, y: jnp.sum(out(x, y) * w), argnums=(0, 1))(a, b)
    _, tangent = jax.jvp(out, (a, b), (ta, tb))
    assert np.shape(tangent) == w.shape
    for g, ref in zip(got["grads"], want):
        assert float(np.abs(np.asarray(ref)).max()) > 0
        np.testing.assert_allclose(g, np.asarray(ref), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got["tangent"], np.asarray(tangent), rtol=1e-12, atol=1e-12)
