"""The training runtime's memory and overlap features, on the CPU: the
U-Net's per-block rematerialisation, ``Trainer.fit``'s prefetch thread, and
``ConvBlock``'s strides against the JAX package.

Remat and prefetch change when things are computed, never what: gradients
with remat on and off, and parameters after training with and without
prefetch, must be bit-equal (the same float operations in the same order).
A strided block runs the library convolution with XLA's SAME padding in
every conv mode, as the JAX block does, within ``CONV_RTOL`` (1e-5) of its
largest output (the two libraries sum the products in other orders).
"""

import contextlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_rel_close, flatten
from voxelmorph_tpu.models.unet import ConvBlock as JaxConvBlock
from voxelmorph_tpu_torch import losses
from voxelmorph_tpu_torch.models import modelio
from voxelmorph_tpu_torch.models import unet as unet_module
from voxelmorph_tpu_torch.models.unet import ConvBlock, Unet
from voxelmorph_tpu_torch.models.vxm import VxmDense
from voxelmorph_tpu_torch.ops import conv3
from voxelmorph_tpu_torch.training import LossTerm, Prefetcher, Trainer

CONV_RTOL = 1e-5


@pytest.fixture(params=["cudnn", "conv_kernel"])
def conv_mode(request):
    conv3.set_pallas_conv(request.param == "conv_kernel")
    try:
        yield request.param
    finally:
        conv3.set_pallas_conv(None)


@pytest.fixture
def deterministic_cpu():
    """Deterministic CPU convolutions and reductions for bit-for-bit
    comparisons of two runs: PyTorch's native convolution (oneDNN's is not
    run-to-run deterministic here: about one pair of calls in 40 differed
    by up to 9e-5) on one thread (so that no split of a sum over threads
    depends on the load of the machine). On the card the same comparisons
    run cuDNN with ``cudnn.deterministic``."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with torch.backends.mkldnn.flags(enabled=False):
            yield
    finally:
        torch.set_num_threads(threads)


def _unet_grads(remat, x, seed=0, **kw):
    torch.manual_seed(seed)
    net = Unet(3, x.shape[1], nb_features=[[4, 8], [8, 8, 4, 4]], remat=remat,
               generator=torch.Generator().manual_seed(seed), **kw)
    xg = x.clone().requires_grad_(True)
    out = net(xg)
    loss = (out * torch.linspace(-1, 1, out.numel()).view(out.shape)).sum()
    grads = torch.autograd.grad(loss, [xg, *net.parameters()])
    return net, out, grads


@pytest.mark.parametrize("do_res,final", [(False, None), (True, "tanh")])
def test_unet_remat_gradients_bit_equal(conv_mode, deterministic_cpu, do_res, final):
    """The rematerialised U-Net's output and gradients equal the stored
    one's bit for bit (deterministic convolutions, ``deterministic_cpu``)."""
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 2, 12, 8, 16))
                         .astype(np.float32))
    kw = dict(do_res=do_res, final_activation_function=final)
    net_on, out_on, g_on = _unet_grads(True, x, **kw)
    net_off, out_off, g_off = _unet_grads(False, x, **kw)
    assert net_on.remat and not net_off.remat
    assert torch.equal(out_on, out_off)
    assert len(g_on) == len(g_off) > 10
    for a, b in zip(g_on, g_off):
        assert a.abs().max() > 0 and torch.equal(a, b)
    # no parameter or key added: checkpoints load either way
    assert list(net_on.state_dict()) == list(net_off.state_dict())
    net_off.load_state_dict(net_on.state_dict())


def test_unet_remat_runs_only_while_autograd_records(monkeypatch):
    calls = []
    real = unet_module.checkpoint

    def counting(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(unet_module, "checkpoint", counting)
    net = Unet(3, 2, nb_features=[[4, 8], [8, 8, 4]])
    x = torch.zeros(1, 2, 8, 8, 8)
    with torch.no_grad():
        net(x)
    with torch.inference_mode():
        net(x)
    assert calls == []
    net(x)
    assert len(calls) == 5  # every conv block: 2 encoder, 2 decoder, 1 final


def test_vxm_checkpoint_keys_unchanged_by_remat():
    """VxmDense's U-Net rematerialises by default; its state dict is the
    JAX parameter tree's, key for key, as without remat."""
    model = VxmDense(inshape=(8, 8, 8), nb_unet_features=[[4, 8], [8, 4]])
    assert model.unet.remat
    flat = modelio.params_to_jax(model.state_dict())
    assert set(modelio.params_from_jax(flat)) == set(model.state_dict())


@pytest.mark.parametrize("shape", [(9, 12, 7), (8, 8, 10)])
@pytest.mark.parametrize("strides", [1, 2, 3])
def test_strided_conv_block_matches_jax(conv_mode, shape, strides):
    rng = np.random.default_rng(strides)
    x = rng.normal(size=(2, *shape, 3)).astype(np.float32)
    jblock = JaxConvBlock(features=5, ndims=3, strides=strides)
    params = jblock.init(jax.random.PRNGKey(strides), jnp.asarray(x))["params"]
    params = dict(params, conv=dict(params["conv"], bias=jnp.asarray(
        rng.normal(size=5).astype(np.float32))))
    ref = jblock.apply({"params": params}, jnp.asarray(x))
    block = ConvBlock(3, 5, 3, strides=strides)
    block.load_state_dict(modelio.params_from_jax(flatten(params)))
    got = block(torch.from_numpy(x).movedim(-1, 1)).movedim(1, -1)
    assert tuple(got.shape) == tuple(ref.shape)
    assert_rel_close(got.detach().numpy(), ref, CONV_RTOL, f"stride {strides}")


def _batches(seed, n=20, shape=(8, 8, 8)):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        a, b = (rng.normal(size=(1, *shape, 1)).astype(np.float32) for _ in range(2))
        yield ([a, b], [b, np.zeros((1, *shape, 3), np.float32)])


def test_prefetcher_yields_the_same_items_in_order():
    ref = list(_batches(3, 12))
    pre = Prefetcher(_batches(3, 12), size=2)
    got = list(pre)
    pre.close()
    assert len(got) == len(ref)
    for (gi, gt), (ri, rt) in zip(got, ref):
        assert all(np.array_equal(a, b) for a, b in zip(gi + gt, ri + rt))
    with pytest.raises(StopIteration):
        next(pre)
    with pytest.raises(ValueError):
        Prefetcher(iter([]), size=0)


def test_prefetcher_raises_the_producers_error_and_stops():
    def failing():
        yield 1
        yield 2
        raise KeyError("bad volume")

    pre = Prefetcher(failing(), size=2)
    assert next(pre) == 1 and next(pre) == 2
    with pytest.raises(KeyError, match="bad volume"):
        next(pre)
    pre.close()
    assert not pre._thread.is_alive()
    # an endless generator: close stops the thread though the queue is full
    pre = Prefetcher(iter(lambda: 0, 1), size=1)
    assert next(pre) == 0
    pre.close()
    assert not pre._thread.is_alive()


def test_prefetcher_orders_its_stream_after_the_callers(monkeypatch):
    """On a CUDA device the producer's stream waits for the work queued on
    the caller's stream before the first draw (a generator drawn once
    before ``fit`` left its state there), and the caller's stream waits for
    each item's event. CUDA's stream calls are stood in for by recorders."""
    log = []

    class Stream:
        def __init__(self, name):
            self.name = name

        def wait_stream(self, other):
            log.append(("wait_stream", self.name, other.name))

        def wait_event(self, event):
            log.append(("wait_event", self.name, event.item))

    class Event:
        def record(self, stream):
            self.item = drawn[-1]
            log.append(("record", stream.name, self.item))

    producer, consumer, drawn = Stream("producer"), Stream("consumer"), []
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: producer)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: consumer)
    monkeypatch.setattr(torch.cuda, "set_device", lambda device: None)
    monkeypatch.setattr(torch.cuda, "stream", lambda stream: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Event", Event)

    def generator():
        for item in range(3):
            drawn.append(item)
            log.append(("draw", item))
            yield item

    pre = Prefetcher(generator(), size=1, device="cuda:0")
    assert [next(pre) for _ in range(3)] == [0, 1, 2]
    pre.close()
    assert log[0] == ("wait_stream", "producer", "consumer")
    for item in range(3):
        made = log.index(("record", "producer", item))
        assert log[made - 1] == ("draw", item)
        assert log.index(("wait_event", "consumer", item)) > made


def _trainer(seed=0):
    model = VxmDense(inshape=(8, 8, 8), nb_unet_features=[[4, 8], [8, 4]], int_steps=3,
                     generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        model.flow.weight.normal_(0, 0.3, generator=torch.Generator().manual_seed(seed + 1))
    terms = [LossTerm("y_source", losses.MSE().loss),
             LossTerm("pos_flow", losses.Grad("l2").loss, weight=0.01)]
    return Trainer(model, terms, lr=1e-3, device="cpu")


@pytest.mark.parametrize("drawn_first", [False, True])
@pytest.mark.parametrize("size", [1, 2])
def test_fit_prefetch_is_bit_equal_to_inline(deterministic_cpu, size, drawn_first):
    """``drawn_first`` draws one batch on the caller's thread before
    ``fit``, as the point-cloud CLI does."""
    runs = {}
    for prefetch in (0, size):
        trainer = _trainer()
        batches = _batches(5)
        if drawn_first:
            next(batches)
        seen = []
        step = trainer.train_step

        def recording(inputs, targets, step=step, seen=seen):
            seen.append([np.array(a) for a in inputs])
            return step(inputs, targets)

        trainer.train_step = recording
        before = threading.active_count()
        trainer.fit(batches, epochs=2, steps_per_epoch=3, log_fn=lambda s: None,
                    prefetch_size=prefetch)
        assert threading.active_count() == before  # the producer stopped
        runs[prefetch] = (seen, {k: v.clone() for k, v in trainer.model.state_dict().items()})
    (seen0, params0), (seen1, params1) = runs[0], runs[size]
    assert len(seen0) == len(seen1) == 6
    for a, b in zip(seen0, seen1):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert any(not torch.equal(params0[k], _trainer().model.state_dict()[k]) for k in params0)
    for k in params0:
        assert torch.equal(params0[k], params1[k]), k


def test_fit_raises_a_generator_error():
    def failing():
        yield from _batches(6, 2)
        raise RuntimeError("generator failed")

    trainer = _trainer()
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="generator failed"):
        trainer.fit(failing(), epochs=1, steps_per_epoch=4, log_fn=lambda s: None)
    assert threading.active_count() == before
