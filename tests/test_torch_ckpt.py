"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
package's on the 4-layer fixture: what one package writes, the other
restores with the same bits, names and meta, and the CLIs write the same
files at the same boundaries."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import fl_round_fixture

from repro.checkpoint import checkpoint as jckpt
from repro.core import flat as jflat
from repro.launch import train as jtrain
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core import flat
from repro_torch.launch import train
from repro_torch.models.model import params_from_numpy
from repro_torch.tree import leaves, leaves_with_path, tree_map

torch.set_num_threads(2)

JCFG, JPARAMS = fl_round_fixture()
CFG = train.fl_config("smollm-135m", "cls", 10, full_size=False)
META = {"round": 3, "strategy": "fedfa"}


def _port_params():
    return params_from_numpy(jax.tree.map(np.asarray, JPARAMS), CFG, "cpu")


def _bits(a) -> np.ndarray:
    a = np.asarray(a.detach() if isinstance(a, torch.Tensor) else a)
    return a.view(np.uint32)


def _assert_same_bits(port_tree, jax_tree):
    xs, ys = leaves(port_tree), jax.tree.leaves(jax_tree)
    assert len(xs) == len(ys)
    for x, y in zip(xs, ys):
        assert x.dtype == torch.float32 and tuple(x.shape) == y.shape
        np.testing.assert_array_equal(_bits(x), _bits(y))


def test_port_save_restores_in_jax(tmp_path):
    path = str(tmp_path / "port")
    ckpt.save(path, _port_params(), meta=META)
    spec = json.loads((tmp_path / "port.json").read_text())
    assert spec["names"] == [jax.tree_util.keystr(p) for p, _ in
                             jax.tree_util.tree_flatten_with_path(JPARAMS)[0]]
    assert "['stages'][0][0]['attn']['wk']" in spec["names"]
    tree, meta = jckpt.restore(path, JPARAMS)
    assert meta == META
    _assert_same_bits(_port_params(), tree)


def test_jax_save_restores_in_port(tmp_path):
    path = str(tmp_path / "jax")
    jckpt.save(path, JPARAMS, meta=META)
    tree, meta = ckpt.restore(path, _port_params())
    assert meta == META
    _assert_same_bits(tree, JPARAMS)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_buffers_cross_between_packages(writer, tmp_path):
    path = str(tmp_path / writer)
    jindex = jflat.get_index(JPARAMS)
    jbuf = jflat.flatten(jindex, JPARAMS)
    params = _port_params()
    index = flat.FlatIndex(params)
    if writer == "port":
        ckpt.save_from_buffer(path, index, flat.flatten(index, params),
                              meta=META)
        _, buf, meta = jckpt.restore_to_buffer(path, JPARAMS)
        assert isinstance(buf, jax.Array)
    else:
        jckpt.save_from_buffer(path, jindex, jbuf, meta=META)
        got_index, buf, meta = ckpt.restore_to_buffer(path, params)
        assert got_index.n == index.n and buf.dtype == torch.float32
        assert buf.device == params["embed"].device
    assert meta == dict(META, flat_n=index.n) and index.n == jindex.n
    np.testing.assert_array_equal(_bits(buf), _bits(jbuf))


def test_bf16_leaves_cross_between_packages(tmp_path):
    """bf16 leaves are stored as numpy writes ml_dtypes.bfloat16: raw
    2-byte records.  The JAX package cannot read them back (numpy has no
    cast from them); the port restores both packages' files."""
    jtree = {"a": jnp.arange(-3, 5, dtype=jnp.bfloat16) / 3,
             "b": (jnp.ones((2, 3), jnp.float32),)}
    tree = {"a": torch.arange(-3, 5).to(torch.bfloat16) / 3,
            "b": (torch.ones((2, 3)),)}
    jckpt.save(str(tmp_path / "jax"), jtree)
    ckpt.save(str(tmp_path / "port"), tree)
    with np.load(tmp_path / "jax.npz") as j, np.load(tmp_path / "port.npz") as p:
        assert j["a0"].dtype == p["a0"].dtype
        assert j["a0"].tobytes() == p["a0"].tobytes()
    for who in ("jax", "port"):
        got, _ = ckpt.restore(str(tmp_path / who), tree)
        assert got["a"].dtype == torch.bfloat16
        assert torch.equal(got["a"], tree["a"])
        assert torch.equal(got["b"][0], tree["b"][0])


@pytest.mark.parametrize("what", ["structure", "shape"])
def test_restore_rejects_mismatch(what, tmp_path):
    path = str(tmp_path / "x")
    params = _port_params()
    ckpt.save(path, params)
    if what == "structure":
        like = {k: v for k, v in params.items() if k != "lm_head"}
        match = "structure mismatch"
    else:
        like = dict(params, embed=params["embed"][:, :8])
        match = r"shape mismatch at \['embed'\]"
    with pytest.raises(ValueError, match=match):
        ckpt.restore(path, like)
    with pytest.raises(ValueError, match=match):
        ckpt.restore_to_buffer(path, like)


def test_restore_takes_like_dtype(tmp_path):
    """Each leaf comes back in the dtype of ``like``'s leaf."""
    params = _port_params()
    like = tree_map(lambda t: t.to(torch.bfloat16), params)
    ckpt.save(str(tmp_path / "x"), params)
    got, _ = ckpt.restore(str(tmp_path / "x"), like)
    for (p, x), (_, y) in zip(leaves_with_path(got), leaves_with_path(params)):
        assert x.dtype == torch.bfloat16, p
        assert torch.equal(x, y.to(torch.bfloat16)), p


@pytest.mark.parametrize("driver", ["resident", "per-round"])
def test_cli_writes_the_reference_files(driver, tmp_path):
    """3 rounds with eval every 2: both CLIs write rounds 0 and 2, under
    the same names, with the same leaf names and meta."""
    jtrain.run_fl("smollm-135m", 3, 2, batch=2, seq_len=8, eval_every=2,
                  driver=driver, ckpt=str(tmp_path / "jax" / "x"), quiet=True)
    train.main(["--rounds", "3", "--clients", "2", "--batch", "2",
                "--seq-len", "8", "--eval-every", "2", "--driver", driver,
                "--device", "cpu", "--ckpt", str(tmp_path / "port" / "x")])
    files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert files == [f"x_r{r:05d}.{e}" for r in (0, 2) for e in ("json", "npz")]
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == files
    for name in files[::2]:
        j = json.loads((tmp_path / "jax" / name).read_text())
        p = json.loads((tmp_path / "port" / name).read_text())
        assert p == j     # names, and meta (round, strategy, flat_n if any)
