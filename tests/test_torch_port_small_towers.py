"""The port's LeNet, MimicMLP, GRUNet and LstmClassifier
(``models/{lenet,mlp,rnn}.py``) against the JAX package's on the CPU, at
their real widths with small batches, from the JAX init's weights.

fp32: forward in train and eval mode, parameter gradients and the BN
buffers to ~1e-5 (two fp32 implementations summing in another order;
LeNet's train-mode BN over a batch of 4 and its max-pools amplify that
rounding, and numpy seed 0's inputs cross no ReLU or max-pool threshold
within it).  bf16: the forward to BF16_TOL of the largest logit, since
every layer rounds to 8 bits on both sides and XLA's CPU backend fuses
some bf16 elementwise work in fp32.

The parameter-set test trains the two recurrent towers three steps under
Adam and three under SGD (momentum 0.9, weight decay 1e-4) on both sides,
in float64 (Adam divides each gradient by its own magnitude, so in fp32
the rounding of a near-zero gradient entry moves its weight by a part of
the learning rate): every flax GRU and LSTM leaf must stay within 1e-6.  torch's own
``nn.GRU`` and ``nn.LSTM``, loaded through the JAX package's bias folding
(``models/torch_port.py``), match at step 0 and part from step 1, because
their two biases per gate both train: the test of that shows what the
first one would catch.

State dicts round-trip through the JAX package's ``port_lenet``,
``port_gru_cell``, ``port_lstm_classifier`` and ``port_torch_linear``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_clinical_tpu.engine import state as jax_state
from multimodal_clinical_tpu.models import lenet as jax_lenet
from multimodal_clinical_tpu.models import mlp as jax_mlp
from multimodal_clinical_tpu.models import rnn as jax_rnn
from multimodal_clinical_tpu.models import torch_port
from multimodal_clinical_tpu_torch.engine.state import make_optimizer
from multimodal_clinical_tpu_torch.models import lenet, mlp, rnn
from multimodal_clinical_tpu_torch.models.jax_weights import (
    get_leaf, jax_key_map, load_jax_variables, to_torch_layout,
)
from torch_port_contract_harness import FAST_INIT, _Namespace

torch.set_num_threads(2)

B = 4
FP32_TOL = 1e-5
# train-mode BN over the 4 values per channel of LeNet(6, 5)'s last block
# (1 x 1 at batch 4) amplifies the gradients' fp32 rounding: 1.2e-5 of
# the largest entry measured in its last conv's
GRAD_TOL = 5e-5
BF16_TOL = 2 ** -5
LEAF_TOL = 1e-6

# name -> (JAX module, port module, input shape, classes or out features)
TOWERS = {
    "lenet_6_3": (lambda dt: jax_lenet.LeNet(6, 3, dtype=dt),
                  lambda dt: lenet.LeNet(1, 6, 3, dt), (28, 28, 1)),
    "lenet_6_5": (lambda dt: jax_lenet.LeNet(6, 5, dtype=dt),
                  lambda dt: lenet.LeNet(1, 6, 5, dt), (112, 112, 1)),
    "mimic_mlp": (lambda dt: jax_mlp.MimicMLP(6, dtype=dt),
                  lambda dt: mlp.MimicMLP(6, dtype=dt), (5,)),
    "gru_32": (lambda dt: jax_rnn.GRUNet(32, 6, dtype=dt),
               lambda dt: rnn.GRUNet(12, 32, 6, dt), (24, 12)),
    "lstm_384": (lambda dt: jax_rnn.LstmClassifier(2, dtype=dt),
                 lambda dt: rnn.LstmClassifier(81, 2, dtype=dt), (40, 81)),
}
DTYPES = {"float32": (None, None), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@functools.lru_cache(maxsize=None)
def _init(name, seed):
    """The JAX tower's init on ``_pair``'s input, compiled (op by op it
    takes longer than the tests) without XLA's backend optimisations, as
    numpy.  flax keeps the parameters and BN statistics in ``param_dtype``
    (fp32) whatever the compute dtype, so one init serves every dtype."""
    key = jax.random.PRNGKey(seed)
    x = jnp.zeros((B,) + TOWERS[name][2])
    init = jax.jit(functools.partial(TOWERS[name][0](None).init, train=False))
    variables = init.lower(key, x).compile(FAST_INIT)(key, x)
    return jax.tree_util.tree_map(np.asarray, dict(variables))


def _pair(name, dtype="float32", seed=0):
    """(JAX module, variables, port module with those weights, input)."""
    make_jax, make_port, shape = TOWERS[name]
    jdt, tdt = DTYPES[dtype]
    x = np.random.default_rng(seed).normal(size=(B,) + shape).astype(
        np.float32)
    jm = make_jax(jdt)
    variables = _init(name, seed)
    pm = make_port(tdt)
    load_jax_variables(pm, variables["params"],
                       variables.get("batch_stats", {}))
    return jm, variables, pm, x


@functools.lru_cache(maxsize=None)
def _jax_run(name, dtype="float32"):
    """The JAX tower's outputs on ``_pair``'s input, from its init, in one
    compiled call: the train-mode output, its updated BN statistics and
    (fp32) the parameter gradients of <output, CT>, and the eval-mode
    output; with the port tower's init (the same weights)."""
    jm, variables, pm, x = _pair(name, dtype)
    stats = variables.get("batch_stats", {})

    @jax.jit
    def run(params, stats, x, ct):
        def train(p):
            out, mutated = jm.apply({"params": p, "batch_stats": stats}, x,
                                    train=True, mutable=["batch_stats"])
            return out, mutated.get("batch_stats", {})
        out, vjp, new_stats = jax.vjp(train, params, has_aux=True)
        grads = vjp(ct.astype(out.dtype))[0]
        evaluated = jm.apply({"params": params, "batch_stats": stats}, x,
                             train=False)
        return out, new_stats, grads, evaluated

    shape = jax.eval_shape(lambda x: jm.apply(variables, x, train=False),
                           jnp.asarray(x)).shape
    ct = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    out, new_stats, grads, evaluated = jax.tree_util.tree_map(
        np.asarray, run(variables["params"], stats, jnp.asarray(x),
                        jnp.asarray(ct)))
    return dict(x=x, ct=ct, init=pm.state_dict(), train=out,
                stats=new_stats, grads=grads, eval=evaluated)


def _port(name, dtype="float32"):
    """A fresh port tower with the JAX init's weights."""
    pm = TOWERS[name][1](DTYPES[dtype][1])
    pm.load_state_dict(_jax_run(name, dtype)["init"])
    return pm


def _scaled_err(got, want):
    return np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32)
                  ).max() / np.abs(np.asarray(want, np.float32)).max()


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("name", list(TOWERS))
def test_forward_and_buffers_match_jax(name, train):
    run, pm = _jax_run(name), _port(name)
    pm.train(train)
    with torch.no_grad():
        got = pm(torch.from_numpy(run["x"]))
    assert got.dtype == torch.float32
    assert _scaled_err(got.numpy(), run["train" if train else "eval"]) \
        <= FP32_TOL
    sd = pm.state_dict()
    for key, (coll, path, kind) in jax_key_map(pm).items():
        if coll == "batch_stats":
            want = get_leaf(run["stats"], path) if train else sd[key]
            np.testing.assert_allclose(sd[key].numpy(), want,
                                       rtol=FP32_TOL, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("name", list(TOWERS))
def test_gradients_match_jax(name):
    run, pm = _jax_run(name), _port(name)
    pm.train()
    (pm(torch.from_numpy(run["x"])) * torch.from_numpy(run["ct"])
     ).sum().backward()
    named = dict(pm.named_parameters())
    for key, (coll, path, kind) in jax_key_map(pm).items():
        if coll == "params":
            want = to_torch_layout(kind, get_leaf(run["grads"], path))
            assert _scaled_err(named[key].grad.numpy(), want) <= GRAD_TOL, key


@pytest.mark.parametrize("name", list(TOWERS))
def test_bf16_forward_matches_jax(name):
    run, pm = _jax_run(name, "bfloat16"), _port(name, "bfloat16")
    for train in (False, True):  # eval first: training moves the buffers
        assert run["train"].dtype == jnp.bfloat16
        pm.train(train)
        with torch.no_grad():
            got = pm(torch.from_numpy(run["x"]))
        assert got.dtype == torch.bfloat16
        want = run["train" if train else "eval"]
        assert _scaled_err(got.float().numpy(), want) <= BF16_TOL, train


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_recurrent_carry_stays_fp32(dtype):
    """The gates compute in the module's dtype; the carry starts in fp32
    and the promotion keeps it there, so the last hidden state is fp32."""
    tdt = DTYPES[dtype][1]
    x = torch.randn(2, 5, 12, dtype=tdt or torch.float32)
    assert rnn.GRUCell(12, 8, tdt)(x).dtype == torch.float32
    assert rnn.LSTMCell(12, 8, tdt)(x).dtype == torch.float32


def _torch_gru_state(sd, prefix):
    """The port's GRU parameters as ``torch.nn.GRU``'s, whose r and z
    hidden-side biases flax has not: zero."""
    bias_hn = sd[prefix + "bias_hn_l0"]
    return {prefix + "weight_ih_l0": sd[prefix + "weight_ih_l0"],
            prefix + "weight_hh_l0": sd[prefix + "weight_hh_l0"],
            prefix + "bias_ih_l0": sd[prefix + "bias_ih_l0"],
            prefix + "bias_hh_l0": torch.cat([torch.zeros(2 * len(bias_hn)),
                                              bias_hn])}


def _ported_back(name, sd):
    """The JAX package's port functions on the port's state_dict: (params,
    batch_stats)."""
    lin = lambda p: torch_port.port_torch_linear(sd[p + ".weight"],
                                                 sd[p + ".bias"])
    if name.startswith("lenet"):
        return torch_port.port_lenet(sd, num_blocks=len(
            [k for k in sd if k.startswith("convs.")]))
    if name == "mimic_mlp":
        return {f"TorchDense_{i}": lin(f"layers.{i}") for i in range(4)}, {}
    if name == "gru_32":
        return {"GRUCell_0": torch_port.port_gru_cell(
                    _torch_gru_state(sd, "gru."), prefix="gru."),
                "TorchDense_0": lin("fc1"), "TorchDense_1": lin("fc2"),
                "TorchDense_2": lin("fc3")}, {}
    return torch_port.port_lstm_classifier(sd), {}


@pytest.mark.parametrize("name", list(TOWERS))
def test_state_dict_round_trips_through_the_jax_port(name):
    """load_jax_variables is the exact inverse of the JAX package's
    ``port_*``: the port's trained-looking state_dict, ported to a flax tree
    and loaded back, is bit-equal; the tree has exactly the JAX init's
    leaves."""
    pm = _port(name)
    variables = jax.eval_shape(lambda x: TOWERS[name][0](None).init(
        jax.random.PRNGKey(0), x, train=False), _jax_run(name)["x"])
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for t in pm.state_dict().values():
            t.add_(torch.randn(t.shape, generator=gen))
    sd = {k: v.clone() for k, v in pm.state_dict().items()}
    params, stats = _ported_back(name, sd)
    leaves = lambda tree: sorted(
        "/".join(p.key for p in path) for path, _ in
        jax.tree_util.tree_flatten_with_path(tree)[0])
    assert leaves(params) == leaves(variables["params"])
    assert leaves(stats) == leaves(variables.get("batch_stats", {}))
    fresh = TOWERS[name][1](None)
    load_jax_variables(fresh, params, stats)
    for key, value in fresh.state_dict().items():
        assert torch.equal(value, sd[key]), key


# -- the parameter set: three Adam and three SGD steps -----------------------

STEPS = 3
OPTIMIZERS = {"adam": dict(optimizer="adam", lr=1e-2),
              "sgd": dict(optimizer="sgd", lr=1e-1, momentum=0.9,
                          weight_decay=1e-4)}


def _f64_carry(cell):
    class Cell(cell):
        """The flax cell with its carry in float64: flax starts it in
        ``param_dtype`` (fp32), and a float64 scan must keep its type."""

        def initialize_carry(self, rng, input_shape):
            return jax.tree_util.tree_map(
                lambda c: c.astype(jnp.float64),
                super().initialize_carry(rng, input_shape))
    Cell.__name__ = cell.__name__  # flax names the scope after the class
    return Cell


def _pair64(name, monkeypatch):
    """``_pair`` in float64: the JAX variables and input as float64 numpy,
    the JAX cells with a float64 carry, the port tower in float64."""
    nn = jax_rnn.nn
    monkeypatch.setattr(jax_rnn, "nn", _Namespace(
        nn, GRUCell=_f64_carry(nn.GRUCell),
        OptimizedLSTMCell=_f64_carry(nn.OptimizedLSTMCell)))
    with jax.enable_x64(True):
        jm, variables, pm, x = _pair(name)
    to64 = lambda a: np.asarray(a, np.float64)
    return (jm, jax.tree_util.tree_map(to64, variables), pm.double(),
            to64(x))


def _jax_train(jm, variables, x, labels, opt):
    """STEPS optimizer steps of the JAX tower on CE, in float64: the final
    params."""
    tx = jax_state.make_optimizer(
        optax.constant_schedule(opt["lr"]), optimizer=opt["optimizer"],
        momentum=opt.get("momentum", 0.0),
        weight_decay=opt.get("weight_decay", 0.0))

    def step(params, opt_state):
        def loss(p):
            logits = jm.apply({"params": p}, jnp.asarray(x), train=True)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, jnp.asarray(labels)).mean()
        updates, opt_state = tx.update(jax.grad(loss)(params), opt_state,
                                       params)
        return optax.apply_updates(params, updates), opt_state

    with jax.enable_x64(True):
        params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
        opt_state = tx.init(params)
        step = jax.jit(step)
        for _ in range(STEPS):
            params, opt_state = step(params, opt_state)
        assert params["TorchDense_0"]["Dense_0"]["kernel"].dtype == \
            jnp.float64
        return jax.tree_util.tree_map(np.asarray, params)


def _port_train(model, x, labels, opt):
    optimizer = make_optimizer(model.parameters(), opt["lr"],
                               opt.get("momentum", 0.0),
                               opt.get("weight_decay", 0.0),
                               opt["optimizer"])
    for _ in range(STEPS):
        optimizer.zero_grad()
        torch.nn.functional.cross_entropy(
            model(torch.from_numpy(x)), torch.from_numpy(labels)).backward()
        optimizer.step()


def _cell_leaf_errors(trained, params):
    """|port - flax| of every recurrent-cell leaf: {flax path: max}."""
    sd = trained.state_dict()
    errors = {}
    for key, (coll, path, kind) in jax_key_map(trained).items():
        if kind not in ("gates", "gate_biases"):
            continue
        want = to_torch_layout(kind, get_leaf(params, path))
        got = sd[key].numpy()
        start = 0
        for p, leaf in zip(path, get_leaf(params, path)):
            n = to_torch_layout("dense" if kind == "gates" else "vector",
                                leaf).shape[0]
            errors["/".join(p)] = np.abs(got[start:start + n]
                                         - want[start:start + n]).max()
            start += n
    return errors


@pytest.mark.parametrize("opt", list(OPTIMIZERS))
@pytest.mark.parametrize("name", ["gru_32", "lstm_384"])
def test_cell_parameters_equal_flax_after_training(name, opt, monkeypatch):
    jm, variables, pm, x = _pair64(name, monkeypatch)
    labels = np.random.default_rng(2).integers(0, 2, B)
    want = _jax_train(jm, variables, x, labels, OPTIMIZERS[opt])
    pm.train()
    _port_train(pm, x, labels, OPTIMIZERS[opt])
    errors = _cell_leaf_errors(pm, want)
    leaves = {"gru_32": 10, "lstm_384": 12}[name]
    assert len(errors) == leaves
    assert max(errors.values()) <= LEAF_TOL, errors


class _TorchRnnTower(torch.nn.Module):
    """The port's tower with ``torch.nn.GRU`` / ``torch.nn.LSTM`` (two bias
    vectors per gate) in place of the flax cell."""

    def __init__(self, tower, cell):
        super().__init__()
        self.tower = tower
        self.cell = cell

    def forward(self, x):
        t = self.tower
        if isinstance(t, rnn.GRUNet):
            _, h = self.cell(x)
            h = torch.relu(t.fc1(h[-1]))
            return t.fc3(torch.relu(t.fc2(h)))
        _, (h, _) = self.cell(t.fc1(x))
        return t.fc3(torch.relu(t.fc2(h[-1])))


def _torch_rnn_tower(name, pm):
    """``_TorchRnnTower`` with the port tower's weights, the biases folded
    as the JAX package's ``port_gru_cell`` / ``port_lstm_cell`` read them."""
    sd = pm.state_dict()
    if name == "gru_32":
        cell = torch.nn.GRU(12, 32, batch_first=True)
        cell.load_state_dict({k[len("gru."):]: v for k, v in
                              _torch_gru_state(sd, "gru.").items()})
    else:
        cell = torch.nn.LSTM(384, 384, batch_first=True)
        w = {k[len("lstm."):]: v for k, v in sd.items()
             if k.startswith("lstm.")}
        w["bias_ih_l0"] = torch.zeros_like(w["bias_hh_l0"])
        cell.load_state_dict(w)
    return _TorchRnnTower(pm, cell)


def _torch_cell_as_flax(name, model):
    sd = model.cell.state_dict()
    if name == "gru_32":
        return {"GRUCell_0": torch_port.port_gru_cell(sd, prefix="")}
    return {"OptimizedLSTMCell_0": torch_port.port_lstm_cell(sd, prefix="")}


@pytest.mark.parametrize("name", ["gru_32", "lstm_384"])
def test_torch_cells_with_folded_biases_drift_from_flax(name, monkeypatch):
    """What the test above guards against: torch's cells match flax at
    step 0 (the forward) and part by about the learning rate at step 1."""
    jm, variables, pm, x = _pair64(name, monkeypatch)
    model = _torch_rnn_tower(name, pm).double()
    with torch.no_grad():
        np.testing.assert_allclose(model(torch.from_numpy(x)).numpy(),
                                   pm(torch.from_numpy(x)).numpy(),
                                   rtol=1e-5, atol=1e-6)
    labels = np.random.default_rng(2).integers(0, 2, B)
    opt = dict(OPTIMIZERS["adam"])
    want = _jax_train(jm, variables, x, labels, opt)
    _port_train(model, x, labels, opt)
    got = _torch_cell_as_flax(name, model)
    cell = next(iter(got))
    bias_gap = max(np.abs(leaf["bias"] - want[cell][gate]["bias"]).max()
                   for gate, leaf in got[cell].items() if "bias" in leaf)
    assert bias_gap > 100 * LEAF_TOL
