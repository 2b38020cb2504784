"""``repro_torch.checkpoint`` against ``repro.checkpoint``.

The port flattens dicts, lists and tuples itself where the reference uses
``jax.tree_util``: the flattened keys must be jax's paths (dict keys in
sorted order, list and tuple indices as numbers, ``/``-joined, ``_root``
for a bare leaf, ``None`` an empty subtree), the manifest's ``treedef`` the
string jax prints, and torch tensors land as host numpy. A checkpoint
written by either package restores in the other: a nested tree (with and
without ``like``) and a coordinator's state, to the same bits and the same
solved head. One ``SnapshotDaemon`` tick against a port service writes a
snapshot both packages restore, named by the same digest.
"""

import json

import jax
import numpy as np
import pytest
import torch

from repro import checkpoint as ref_ckpt
from repro.checkpoint.snapshot import state_digest as ref_digest
from repro.fl import AFLServer as RefServer
from repro.fl import AsyncAFLServer as RefAsync
from repro_torch import checkpoint as ckpt
from repro_torch.checkpoint.snapshot import state_digest
from repro_torch.fl import (AFLServer, AsyncAFLServer, FederationService,
                            RemoteCoordinator, make_report)

DIM, C, GAMMA = 16, 4, 1.0


def _reports(n=6, rows=5, seed=0):
    rng = np.random.default_rng(seed)
    return [make_report(k, rng.standard_normal((rows, DIM)),
                        np.eye(C)[rng.integers(0, C, rows)], GAMMA) for k in range(n)]


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": rng.standard_normal((3, 4)), "b": rng.standard_normal(4)},
        "layers": [{"k": rng.standard_normal((2, 2))}, (rng.standard_normal(5), 7)],
        "step": np.int64(12),
        "lr": 0.5,
        "empty": None,
        "pair": (rng.standard_normal(1),),
    }


def _jax_keys(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return ["/".join(str(p.key) if hasattr(p, "key") else str(p.idx) for p in path)
            or "_root" for path, _ in flat]


@pytest.mark.parametrize("tree", [_tree(), [1.0, [2.0, (3.0,)]], np.arange(3.0),
                                  {"b": 1.0, "a": {"d": [], "c": 2.0}}])
def test_keys_and_treedef_are_jax_s(tree, tmp_path):
    ckpt.save(tmp_path, tree)
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    assert manifest["keys"] == sorted(_jax_keys(tree))
    assert list(ckpt._flatten(tree)) == _jax_keys(tree)        # flattening order
    assert manifest["treedef"] == str(jax.tree_util.tree_structure(tree))


def test_tensors_go_to_host_numpy(tmp_path):
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "h": [torch.ones(2, dtype=torch.float64), np.zeros(1)]}
    ckpt.save(tmp_path, tree)
    back = ref_ckpt.restore(tmp_path)
    np.testing.assert_array_equal(back["w"], np.arange(6, dtype=np.float32).reshape(2, 3))
    assert back["w"].dtype == np.float32 and back["h/0"].dtype == np.float64
    like = ckpt.restore(tmp_path, like=tree)
    assert isinstance(like["h"], list) and isinstance(like["w"], np.ndarray)
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(tmp_path, like={"w": np.zeros((3, 2)), "h": [np.ones(2), np.zeros(1)]})
    with pytest.raises(KeyError, match="missing leaf"):
        ckpt.restore(tmp_path, like={"w": np.zeros((2, 3)), "x": np.zeros(1),
                                     "h": [np.ones(2), np.zeros(1)]})


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_a_tree_checkpoint_restores_in_the_other_package(writer, tmp_path):
    tree = _tree(seed=3)
    save, restore = ((ckpt.save, ref_ckpt.restore) if writer == "port"
                     else (ref_ckpt.save, ckpt.restore))
    save(tmp_path, tree, metadata={"note": "x"})
    flat = restore(tmp_path)
    assert sorted(flat) == sorted(_jax_keys(tree))
    back = restore(tmp_path, like=jax.tree_util.tree_map(np.asarray, tree))
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    meta = json.loads((tmp_path / "manifest.json").read_text())["metadata"]
    assert meta == {"note": "x"}


@pytest.mark.parametrize("writer", ["port", "ref"])
@pytest.mark.parametrize("kind", ["sync", "async"])
def test_a_coordinator_checkpoint_restores_in_the_other_package(writer, kind, tmp_path):
    from repro.fl import ClientReport as RefReport

    reps = _reports()
    if writer == "port":
        src = AFLServer(DIM, C, gamma=GAMMA)
        src.submit_many(reps[:4])
        ckpt.save_server(tmp_path, src)
        cls = RefServer if kind == "sync" else RefAsync
        back = ref_ckpt.load_server(tmp_path, cls)
        rest = [RefReport.from_bytes(r.to_bytes()) for r in reps[4:]]
    else:
        src = RefServer(DIM, C, gamma=GAMMA)
        src.submit_many([RefReport.from_bytes(r.to_bytes()) for r in reps[:4]])
        ref_ckpt.save_server(tmp_path, src)
        back = ckpt.load_server(tmp_path, AFLServer if kind == "sync" else AsyncAFLServer)
        rest = reps[4:]
    assert json.loads((tmp_path / "manifest.json").read_text())["metadata"]["kind"] \
        == "AFLServer"
    if kind == "sync":
        assert back.num_clients == 4
        np.testing.assert_array_equal(back.solve(), src.solve())
        back.submit_many(rest)
        w_all = back.solve()
    else:
        import asyncio

        async def body():
            async with back as srv:
                assert srv.num_clients == 4
                np.testing.assert_array_equal(await srv.solve(), src.solve())
                await srv.submit_many(rest)
                return await srv.solve()

        w_all = asyncio.run(body())
    oracle = AFLServer(DIM, C, gamma=GAMMA)
    oracle.submit_many(reps)
    np.testing.assert_array_equal(w_all, oracle.solve())


def test_async_state_is_saved_from_its_loop(tmp_path):
    import asyncio

    with pytest.raises(TypeError, match="coroutine"):
        ckpt.save_server(tmp_path, AsyncAFLServer(DIM, C, gamma=GAMMA))

    async def body():
        async with AsyncAFLServer(DIM, C, gamma=GAMMA) as srv:
            await srv.submit_many(_reports())
            ckpt.save(tmp_path, await srv.state())
            return await srv.solve()

    w = asyncio.run(body())
    np.testing.assert_array_equal(ref_ckpt.load_server(tmp_path).solve(), w)


def test_one_snapshot_daemon_tick(tmp_path):
    reps = _reports()
    svc = FederationService(AFLServer(DIM, C, gamma=GAMMA))
    try:
        rc = RemoteCoordinator(svc)
        rc.submit_many(reps)
        daemon = ckpt.SnapshotDaemon(svc, directory=tmp_path, keep=2)
        path = daemon.snapshot_once()
        assert path is not None and path.name == "snap-000000000006-000000"
        assert daemon.snapshot_once() is None          # same digest: a no-op
        state = rc.state()
        assert state_digest(state) == ref_digest(state)
        meta = json.loads((path / "manifest.json").read_text())["metadata"]
        assert meta["digest"] == state_digest(state) and meta["version"] == 6
        np.testing.assert_array_equal(daemon.restore().solve(), rc.solve())
        np.testing.assert_array_equal(ref_ckpt.load_server(path).solve(), rc.solve())
        assert daemon.latest_version == 6 and not daemon.errors
    finally:
        svc.close()
