"""The port's PNA (``models/gnn.py``) against the JAX package, on the CPU.

The forward, the loss and its gradients on a graph with isolated nodes,
masked edges and nodes, and a crafted tie (a node whose two incoming
edges are the same edge, so its max and min tie in every channel: JAX
and the port both split a tied extremum's gradient evenly); the data
helpers (``random_graph``, ``batch_molecules``, ``build_csr``,
``sample_subgraph``, ``partition_edges_by_dst``) equal to JAX's output
exactly; ``pna_loss_sharded`` over a one-process mesh at S = 1 and 4
against JAX's ``pna_loss``; the config.

Tolerances. The aggregation alone, fed the same messages, is held to
atol 1e-6 (both sum in edge order; it agrees to ~3e-8). The whole model
is held to logits and loss atol 5e-4 / rtol 1e-4 and each gradient leaf
to a relative error (Frobenius norm) of 1e-3: the frameworks' matrix
products give messages ~1e-6 apart, and std = sqrt(E[x^2] - E[x]^2 +
1e-8) cancels where a node's messages are large and close (E[x^2] ~ 1,
a spread of 0.02 moves std by ~1e-5 for a 1e-6 change in a message),
which three layers of degree scalers carry to ~1e-4 in the logits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as JREGISTRY
from repro.configs.base import GNNConfig as JGNNConfig
from repro.models import gnn as JG
from repro_torch.configs import get_config
from repro_torch.configs.base import GNN_SHAPES, GNNConfig
from repro_torch.dist.mesh import make_mesh
from repro_torch.models import gnn as G
from repro_torch.models.convert import gnn_from_jax
from repro_torch.train.train_step import value_and_grad
from test_torch_threads import cap_torch_threads

cap_torch_threads()

SPEC = dict(name="pna", n_layers=3, d_hidden=16, n_classes=5)
RTOL, ATOL, GRAD_REL = 1e-4, 5e-4, 1e-3


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _graph(seed=0, n=40, e=160, d_feat=8):
    """Nodes 0-3 isolated, node 4's only in-edges two copies of one edge
    (its max and min tie), ~20 % of edges and two nodes masked."""
    rng = np.random.default_rng(seed)
    send = rng.integers(0, n, e).astype(np.int32)
    recv = rng.integers(8, n, e).astype(np.int32)      # 0-7 get no edge...
    send[:2], recv[:2] = 11, 4                         # ...but node 4: a tie
    mask = rng.random(e) > 0.2
    mask[:2] = True
    feats = rng.standard_normal((n, d_feat)).astype(np.float32)
    labels = rng.integers(0, SPEC["n_classes"], n).astype(np.int32)
    node_mask = np.ones(n, bool)
    node_mask[[9, 20]] = False
    arrays = dict(feats=feats, senders=send, receivers=recv, edge_mask=mask,
                  node_mask=node_mask, labels=labels)
    return (G.GraphBatch(**{k: torch.from_numpy(v) for k, v in
                            arrays.items()}),
            JG.GraphBatch(**{k: jnp.asarray(v) for k, v in arrays.items()}))


def _models(seed=0, d_feat=8):
    jcfg, cfg = JGNNConfig(**SPEC), GNNConfig(**SPEC)
    p_np = jax.tree.map(np.asarray, JG.init_pna(jax.random.key(seed), jcfg,
                                                 d_feat))
    return jcfg, cfg, jax.tree.map(jnp.asarray, p_np), \
        gnn_from_jax(p_np, cfg, device="cpu")


def _grads_close(grads, jgrads, cfg):
    want = {k: p.detach() for k, p in gnn_from_jax(
        jax.tree.map(np.asarray, jgrads), cfg,
        device="cpu").named_parameters()}
    assert set(grads) == set(want)
    for k in grads:
        err = torch.linalg.vector_norm(grads[k] - want[k])
        assert err <= GRAD_REL * torch.linalg.vector_norm(want[k]), k


def test_pna_forward_loss_and_grads_match_jax():
    jcfg, cfg, jparams, model = _models()
    g, jg = _graph()
    logits = G.pna_forward(model, cfg, g)
    _close(logits, JG.pna_forward(jparams, jcfg, jg))
    assert torch.all(logits[9] == 0) and torch.all(logits[20] == 0)
    # the tie: node 4's max and min aggregates equal its mean
    h = g.feats @ model.encode
    lp = model.layers[0]
    msg = torch.relu(h[g.senders.long()] @ lp.w_msg_src
                     + h[g.receivers.long()] @ lp.w_msg_dst)
    agg, deg = G._aggregate(msg, g.receivers, g.edge_mask, 40,
                            cfg.aggregators)
    d = cfg.d_hidden
    assert deg[4] == 2 and torch.all(deg[:4] == 0)
    assert torch.equal(agg[4, d:2 * d], agg[4, :d])          # max == mean
    assert torch.equal(agg[4, 2 * d:3 * d], agg[4, :d])      # min == mean
    assert torch.all(agg[:4, :3 * d] == 0)                   # isolated
    loss, grads = value_and_grad(lambda: G.pna_loss(model, cfg, g), model)
    jloss, jgrads = jax.value_and_grad(JG.pna_loss)(jparams, jcfg, jg)
    _close(loss, jloss)
    _grads_close(grads, jgrads, cfg)


def test_aggregate_matches_jax_on_the_same_messages():
    _, cfg, _, model = _models()
    g, jg = _graph()
    h = g.feats @ model.encode
    lp = model.layers[0]
    msg = torch.relu(h[g.senders.long()] @ lp.w_msg_src
                     + h[g.receivers.long()] @ lp.w_msg_dst).detach()
    agg, deg = G._aggregate(msg, g.receivers, g.edge_mask, 40,
                            cfg.aggregators)
    jagg, jdeg = JG._aggregate(jnp.asarray(msg.numpy()), jg.receivers,
                               jg.edge_mask, 40, cfg.aggregators)
    _close(agg, jagg, 0, 1e-6)
    _close(deg, jdeg, 0, 0)
    _close(G._scale(agg, deg, cfg.scalers, 2.0),
           JG._scale(jagg, jdeg, cfg.scalers, 2.0), 0, 1e-5)


@pytest.mark.parametrize("aggs", [("max",), ("min",), ("max", "min")])
def test_tied_extremum_splits_its_gradient_evenly(aggs):
    """Two equal messages into one node: each gets half of the max's (and
    of the min's) gradient, as under JAX's rule."""
    msgs = torch.tensor([[2.0, -1.0], [2.0, -1.0], [1.0, 3.0]],
                        requires_grad=True)
    recv = torch.tensor([0, 0, 1], dtype=torch.int32)
    mask = torch.tensor([True, True, True])
    agg, _ = G._aggregate(msgs, recv, mask, 2, aggs)
    agg.sum().backward()

    def jfn(m):
        a, _ = JG._aggregate(m, jnp.asarray([0, 0, 1]),
                             jnp.asarray([True, True, True]), 2, aggs)
        return a.sum()
    want = jax.grad(jfn)(jnp.asarray(msgs.detach().numpy()))
    _close(msgs.grad, want, 0, 0)
    assert torch.all(msgs.grad[:2] == 0.5 * len(aggs))
    assert torch.all(msgs.grad[2] == len(aggs))


def test_data_helpers_equal_jax():
    for args in ((50, 300, 6, 5, 3), (7, 0, 2, 3, 1)):
        got, want = G.random_graph(*args[:4], seed=args[4]), \
            JG.random_graph(*args[:4], seed=args[4])
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got, want = G.batch_molecules(6, 30, 64, 16, 5, seed=2), \
        JG.batch_molecules(6, 30, 64, 16, 5, seed=2)
    for a, b in zip(got, want):
        assert a.dtype == torch.from_numpy(np.asarray(b)).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    rng = np.random.default_rng(1)
    send = rng.integers(0, 200, 2000).astype(np.int32)
    recv = rng.integers(0, 200, 2000).astype(np.int32)
    recv[recv == 17] = 18                   # node 17 isolated: self-loops
    csr, jcsr = G.build_csr(200, send, recv), JG.build_csr(200, send, recv)
    for a, b in zip(csr, jcsr):
        np.testing.assert_array_equal(a, b)
    feats = rng.standard_normal((200, 8)).astype(np.float32)
    labels = rng.integers(0, 5, 200)
    seeds = np.concatenate([[17], np.arange(31)])
    sub = G.sample_subgraph(csr, feats, labels, seeds, (5, 3), seed=4)
    jsub = JG.sample_subgraph(jcsr, feats, labels, seeds, (5, 3), seed=4)
    assert sub.feats.shape == (32 * (1 + 5 + 15), 8)
    for a, b in zip(sub, jsub):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    for parts in (1, 4):
        got = G.partition_edges_by_dst(send, recv, 200, parts)
        want = JG.partition_edges_by_dst(send, recv, 200, parts)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        G.partition_edges_by_dst(send, recv, 200, 3)


@pytest.mark.parametrize("n_shards", [1, 4])
def test_pna_loss_sharded_matches_jax_loss(n_shards):
    """Edges partitioned by destination over S shards on one device: the
    loss and its gradients (through the per-layer all-gathers) equal JAX's
    unsharded ``pna_loss``."""
    jcfg, cfg, jparams, model = _models(seed=1)
    g, jg = _graph(seed=1, n=64, e=256)
    jloss, jgrads = jax.value_and_grad(JG.pna_loss)(jparams, jcfg, jg)
    s, r, m = G.partition_edges_by_dst(g.senders.numpy(),
                                       g.receivers.numpy(), 64, n_shards)
    # keep the graph's own edge mask through the partition
    keep = np.zeros(len(s), bool)
    owner = {}
    for i, (a, b, ok) in enumerate(zip(g.senders.numpy(),
                                       g.receivers.numpy(),
                                       g.edge_mask.numpy())):
        owner.setdefault((a, b), []).append(ok)
    for i in np.flatnonzero(m):
        keep[i] = owner[(s[i], r[i])].pop(0)
    gs = g._replace(senders=torch.from_numpy(s), receivers=torch.from_numpy(r),
                    edge_mask=torch.from_numpy(keep & m))
    mesh = make_mesh((n_shards,), ("data",), device="cpu")
    loss, grads = value_and_grad(
        lambda: G.pna_loss_sharded(model, cfg, gs, mesh), model)
    _close(loss, jloss)
    _grads_close(grads, jgrads, cfg)


def test_pna_config_and_shapes_equal_jax():
    cfg, jcfg = get_config("pna"), JREGISTRY["pna"]
    assert cfg == GNNConfig(**dataclasses.asdict(jcfg))
    assert cfg.family == "gnn" and cfg.d_hidden == 75 and cfg.n_layers == 4
    for got, want in zip(GNN_SHAPES, jcfg.shapes):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    lg = {s.name: s for s in cfg.shapes}["minibatch_lg"]
    assert lg.fanout == (15, 10) and lg.n_edges == 114615892
