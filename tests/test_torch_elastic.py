"""The port's elastic re-meshing (``distributed/elastic.py``) and the
checkpoint's restore onto another mesh (``train/checkpoint.py``).

- ``largest_grid`` and ``remesh`` of a (4, 2) grid that loses its last 2
  of 8 ranks: the grid (3, 2), the survivors in order, ``generation``
  and ``failed_devices`` equal to the JAX package's ``elastic.remesh`` in
  a subprocess with 8 fake CPU devices (as ``tests/test_distributed.py``
  runs it).
- On 4 gloo ranks (``tests/torch_ranks.py``) with a (2, 2)
  ``DeviceMesh``: ``remesh`` after losing rank 3 builds a (1, 2) mesh of
  ranks 0 and 1 while ranks 2 and 3, outside it, return from its
  construction with no coordinate (none hangs); ``reshard`` moves a
  sharded tree onto it with every value kept; a checkpoint saved from
  the (2, 2) mesh restores onto a (2, 1) mesh of ranks 0 and 2, each
  reading its own block, every value and dtype kept (JAX's
  ``test_checkpoint_cross_mesh_restore_8dev`` restores (4, 2) onto
  (2, 2)).
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro_torch.distributed import elastic as E
from torch_ranks import spawn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_largest_grid():
    assert E.largest_grid(8, 2) == (4, 2)
    assert E.largest_grid(7, 2) == (3, 2)
    assert E.largest_grid(5, 1) == (5, 1)
    with pytest.raises(ValueError):
        E.largest_grid(1, 2)


def _jax_remesh() -> dict:
    code = textwrap.dedent("""
        import json
        from repro.distributed import elastic
        from repro.launch.mesh import make_host_mesh
        mesh = make_host_mesh(n_data=4, n_model=2)
        lost = [d.id for d in mesh.devices.flatten()[-2:]]
        st = elastic.remesh(elastic.ElasticState(mesh=mesh), lost,
                            model_parallel=2)
        st = elastic.remesh(st, [st.mesh.devices.flatten()[0].id])
        print(json.dumps(dict(
            shape=[st.mesh.shape["data"], st.mesh.shape["model"]],
            ids=[[d.id for d in row] for row in st.mesh.devices],
            generation=st.generation, failed=list(st.failed_devices))))
    """)
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    import json
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_remesh_equals_jax():
    want = _jax_remesh()
    st = E.remesh(E.ElasticState(mesh=E.RankGrid(np.arange(8).reshape(
        4, 2))), [6, 7], model_parallel=2)
    assert st.mesh.shape == {"data": 3, "model": 2}
    st = E.remesh(st, [int(st.mesh.ranks.flatten()[0])])
    assert [st.mesh.shape["data"], st.mesh.shape["model"]] == want["shape"]
    assert st.mesh.ranks.tolist() == want["ids"]
    assert st.generation == want["generation"] == 2
    assert list(st.failed_devices) == want["failed"]


@pytest.fixture(scope="module")
def elastic_ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("elastic")
    return spawn("elastic", 4, root, dict(root=str(root / "ckpt")),
                 timeout=120)


def test_remesh_of_a_device_mesh_leaves_no_rank_hanging(elastic_ranks):
    for r, res in enumerate(elastic_ranks):
        assert res["generation"] == 1 and res["failed"] == (3,)
        assert res["grid"] == [[0, 1]]
        coord = res["coordinate"]
        assert (list(coord) == [0, r]) if r < 2 else coord is None


def test_reshard_keeps_every_value(elastic_ranks):
    for r, res in enumerate(elastic_ranks[:2]):
        assert res["reshard_equal"] is True
        # on (1, 2) "embed" (64, 16) shards its last dim over "model"
        assert res["reshard_local"][0] == (64, 8)
    assert all("reshard_equal" not in res for res in elastic_ranks[2:])


def test_checkpoint_restores_onto_another_mesh(elastic_ranks):
    for r, res in enumerate(elastic_ranks):
        if r in (0, 2):
            assert res["restore_equal"] is True
            # on (2, 1) "embed" shards its rows over "data"
            assert res["restore_local"][0] == (32, 16)
        else:
            assert res["restore_equal"] is None
