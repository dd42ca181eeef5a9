"""The logical rule table of ``repro_torch.parallel.sharding`` against the
JAX package's (``repro.parallel.sharding``), and the cut of the packed
plane over a (worker, fsdp) mesh (no ranks spawned: the cut is pure
indexing; the collectives run in ``tests/test_torch_dist_fsdp*.py``).

* every key of ``LOGICAL_RULES`` maps to the same mesh axes, and
  ``spec_for`` gives the reference's ``PartitionSpec`` as a tuple, for each
  key alone and for multi-axis specs;
* ``fit_spec`` agrees on dividing and non-dividing shapes (the reference
  reads only ``mesh.shape``: a stand-in with a ``shape`` dict takes the
  mesh's place);
* ``anchor_axes`` and ``tree_shardings`` agree on the axes trees of the
  reduced qwen2-7b and of the classifier (the reference's shardings on a
  one-device mesh of the three axes, compared by their specs);
* ``plane_split``: c_b = ⌈n_b / F⌉ rounded up to 128 (n_b at F 1), a_b =
  ⌈c_b / W⌉ rounded up to 128; over every rank (w, f) of a mesh the column
  slices and the anchor pieces tile the bucket exactly once, and the
  padding past n_b is zero.
"""
import itertools

import jax
import numpy as np
import pytest
import torch

from repro.config import get_arch as jget_arch
from repro.models import classifier as jclf
from repro.models import transformer as JT
from repro.parallel import sharding as jsh
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.packing import layout_of, pack


class _Mesh:
    """The stand-in the reference's ``fit_spec`` reads: a ``shape`` dict."""

    def __init__(self, workers, fsdp, tensor):
        self.shape = {"worker": workers, "fsdp": fsdp, "tensor": tensor}


def _mesh(W, F, w=0, f=0):
    return sh.WorkerMesh(group=None, rank=w, size=W, device=torch.device("cpu"), fsdp=F, fsdp_rank=f)


def test_every_rule_is_the_reference_s():
    assert set(sh.LOGICAL_RULES) == set(jsh.LOGICAL_RULES)
    for key, axes in jsh.LOGICAL_RULES.items():
        assert sh.LOGICAL_RULES[key] == tuple(axes), key
        assert sh.spec_for((key,)) == tuple(jsh.spec_for((key,))), key


@pytest.mark.parametrize("axes", [("worker", "embed", "ff"), ("stacked_batch", "seq", "act_vocab"),
                                  (None, "anchor_embed", "heads", "head_dim"), ("worker", "flat_param"),
                                  ("anchor_flat",), ("experts", "embed", "expert_ff"), ()])
def test_spec_for_matches_the_reference(axes):
    assert sh.spec_for(axes) == tuple(jsh.spec_for(axes))


@pytest.mark.parametrize("mesh", [(2, 2, 1), (2, 4, 2), (1, 2, 1), (3, 2, 16)])
@pytest.mark.parametrize("axes,shape", [(("worker", "embed", "ff"), (4, 64, 48)),
                                        (("worker", "embed", "ff"), (3, 10, 7)),
                                        (("anchor_embed", "vocab"), (96, 32000)),
                                        (("anchor_embed", "vocab"), (6, 31)),
                                        (("anchor_flat",), (1 << 20,)), (("anchor_flat",), (1000,)),
                                        (("worker", "flat_param"), (2, 384)), (("heads",), (28,)),
                                        (("batch", "seq"), (5, 8))])
def test_fit_spec_matches_the_reference(mesh, axes, shape):
    spec = sh.spec_for(axes)
    want = jsh.fit_spec(jsh.spec_for(axes), shape, _Mesh(*mesh))
    assert sh.fit_spec(spec, shape, _Mesh(*mesh)) == tuple(want)
    if mesh[2] == 1:  # a WorkerMesh has tensor 1: its own shape gives the same
        assert sh.fit_spec(spec, shape, _mesh(mesh[0], mesh[1])) == tuple(want)


def _axes_trees():
    cfg = jget_arch("qwen2-7b").model.reduced()
    _, lm_axes = JT.init_model(cfg, jax.random.PRNGKey(0))
    _, clf_axes = jclf.init_mlp(jax.random.PRNGKey(0), 64, 10, hidden=(128, 64))
    return {"qwen2-7b": lm_axes, "classifier": clf_axes}


def _plain(tree):
    """A reference axes tree (dicts of tuples) as plain nested dicts."""
    return {k: _plain(v) for k, v in tree.items()} if isinstance(tree, dict) else tuple(tree)


@pytest.mark.parametrize("model", ["qwen2-7b", "classifier"])
def test_anchor_axes_and_tree_shardings_match_the_reference(model):
    axes = _plain(_axes_trees()[model])
    want = jsh.anchor_axes(axes)
    got = sh.anchor_axes(axes)
    assert got == _plain(want)
    mesh = jsh.make_auto_mesh((1, 1, 1), ("worker", "fsdp", "tensor"))
    for tree, prefix in ((axes, ()), (axes, ("worker",)), (got, ())):
        ref = jax.tree.map(lambda ns: tuple(ns.spec), jsh.tree_shardings(mesh, tree, prefix=prefix),
                           is_leaf=lambda t: hasattr(t, "spec"))
        assert sh.tree_shardings(_mesh(1, 1), tree, prefix=prefix) == ref


def test_constrain_is_a_no_op_and_sharding_for_needs_a_mesh():
    t = torch.zeros(3)
    assert sh.constrain(t, ("embed",)) is t
    assert sh.current_mesh() is None and sh.sharding_for(("embed",)) is None
    assert sh.sharding_for(("worker", "embed"), _mesh(2, 2)) == ("worker", "fsdp")


@pytest.mark.parametrize("W,F", [(1, 1), (2, 1), (1, 2), (2, 2), (4, 2), (3, 3), (2, 4)])
def test_plane_split_tiles_every_bucket_once(W, F):
    """The classifier's f32 plane and a two-bucket plane with a ragged
    leaf: each rank's column slice and anchor piece, put back at their
    columns, give the bucket; the padding is zero."""
    gen = torch.Generator().manual_seed(0)
    trees = [{"a": torch.randn(64, 128, generator=gen), "b": torch.randn(10, generator=gen)},
             {"w": torch.randn(300, 7, generator=gen).to(torch.bfloat16), "v": torch.randn(5, generator=gen)}]
    for tree in trees:
        layout = layout_of(tree)
        px = pack({k: v[None].expand(2, *v.shape) for k, v in tree.items()}, lead=1)
        for b, n in enumerate(layout.bucket_sizes):
            sp = sh.plane_split(layout, _mesh(W, F))
            c = n if F == 1 else -(-(-(-n // F)) // 128) * 128
            a = c if W == 1 else -(-(-(-c // W)) // 128) * 128
            assert (sp.widths[b], sp.cols[b], sp.pieces[b]) == (n, c, a)
            row = px.buffers[b]
            cols = torch.zeros((2, F * c), dtype=row.dtype)
            anchor = torch.zeros(F * W * a, dtype=row.dtype)
            for w, f in itertools.product(range(W), range(F)):
                spw = sh.plane_split(layout, _mesh(W, F, w, f))
                got = sh.cut_to_rank(row, b, spw, "flat_param")
                assert got.shape == (2, c)
                if w == 0:
                    cols[:, f * c : (f + 1) * c] = got
                else:
                    assert torch.equal(got, cols[:, f * c : (f + 1) * c])
                piece = sh.cut_to_rank(row[0], b, spw, "anchor_flat")
                assert piece.shape == (a,)
                anchor[(f * W + w) * a : (f * W + w + 1) * a] = piece
                if F > 1:  # the helpers the state is built with agree with the restore's cut
                    mesh = _mesh(W, F, w, f)
                    xs = sh.shard_columns(px, mesh)
                    assert isinstance(xs, sh.Sharded) and xs.axis == "flat_param"
                    assert torch.equal(xs.buffers[b], got)
                    z = sh.shard_anchor(xs.with_buffers(tuple(t[0] for t in xs.buffers)), mesh)
                    assert z.anchor and torch.equal(z.buffers[b], piece)
            assert torch.equal(cols[:, :n], row) and not cols[:, n:].any()
            whole = anchor.view(F, W * a)[:, :c].reshape(-1)
            assert torch.equal(whole[:n], row[0]) and not whole[n:].any()


def test_unsupported_paths_name_the_second_part():
    err = sh.unsupported_on_ranks("tensor parallelism")
    assert isinstance(err, NotImplementedError) and "ROADMAP Queue 1 item 10c, second part" in str(err)


def test_a_sharded_plane_keeps_its_kind():
    from repro_torch.parallel.packing import packed_like

    tree = {"a": torch.ones(2, 300)}
    px = pack(tree, lead=1)
    xs = sh.shard_columns(px, _mesh(1, 2, 0, 1))
    like = packed_like(xs, 0.0, dtype=torch.float32)
    assert isinstance(like, sh.Sharded) and like.axis == "flat_param" and like.split == xs.split
    assert like.buffers[0].shape == xs.buffers[0].shape and like.buffers[0].dtype == torch.float32
    assert sh.shard_columns(px, _mesh(2, 1)) is px  # F 1: the rows stay whole
    np.testing.assert_array_equal(xs.buffers[0][:, : 384 - 256].numpy(), px.buffers[0][:, 256:384].numpy())
