"""The port's data loader (`deepspeed_tpu_torch/runtime/dataloader.py`)
against the JAX package's (`deepspeed_tpu/runtime/dataloader.py`): the
same batches in the same order over two epochs (the order is a pure
function of ``(seed, epoch)``), ``drop_last``, the default collate, and
the sample cursor a checkpoint restores, also at another batch size.
Then ``initialize(training_data=...)``: the loader comes back as the
third value, and ``train_batch()`` pulls from it. Batches are compared
exactly (they are the dataset's own rows).
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.models.gpt2 import GPT2LMHead, gpt2_tiny
from deepspeed_tpu_torch.runtime.dataloader import (
    DeepSpeedDataLoader,
    RepeatingLoader,
)


class TokenDataset:
    """Indexable dataset of dict samples made from a seed."""

    def __init__(self, n, t=16, seed=0, vocab=256):
        rng = np.random.default_rng(seed)
        self.ids = rng.integers(0, vocab, (n, t)).astype(np.int32)
        self.w = rng.standard_normal(n).astype(np.float32)

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i):
        return {"input_ids": self.ids[i], "w": self.w[i]}


def _jax_loader(dataset, batch_size, **kw):
    from deepspeed_tpu.runtime.dataloader import (
        DeepSpeedDataLoader as JaxLoader)
    return JaxLoader(dataset, batch_size, process_index=0, process_count=1,
                     **kw)


def _same(port_batch, jax_batch):
    assert set(port_batch) == set(jax_batch)
    for k, v in port_batch.items():
        assert isinstance(v, torch.Tensor) and v.device.type == "cpu"
        np.testing.assert_array_equal(v.numpy(), jax_batch[k])


@pytest.mark.parametrize("n,batch,shuffle", [(37, 8, True), (32, 8, True),
                                             (20, 5, False)])
def test_batches_match_jax_loader_over_two_epochs(n, batch, shuffle):
    from deepspeed_tpu.runtime.dataloader import (
        RepeatingLoader as JaxRepeating)
    data = TokenDataset(n)
    port = RepeatingLoader(DeepSpeedDataLoader(data, batch, shuffle=shuffle,
                                               seed=3))
    ref = JaxRepeating(_jax_loader(data, batch, shuffle=shuffle, seed=3))
    per_epoch = n // batch
    for _ in range(2 * per_epoch + 1):
        _same(next(port), next(ref))
    assert port.epoch == ref.epoch == 2
    assert port.state_dict() == ref.state_dict()


def test_drop_last_and_collate_forms():
    data = TokenDataset(10)
    loader = DeepSpeedDataLoader(data, 4, shuffle=False)
    assert len(loader) == 2 == len(list(loader))
    keep = DeepSpeedDataLoader(data, 4, shuffle=False, drop_last=False)
    assert [len(b["w"]) for b in keep] == [4, 4, 2]
    pairs = [(np.full(3, i), np.float32(i)) for i in range(6)]
    x, y = next(iter(DeepSpeedDataLoader(pairs, 3, shuffle=False)))
    assert x.shape == (3, 3) and torch.equal(y, torch.tensor([0., 1., 2.]))
    arrays = [np.arange(4) + i for i in range(6)]
    assert next(iter(DeepSpeedDataLoader(arrays, 2, shuffle=False))).shape \
        == (2, 4)


@pytest.mark.parametrize("new_batch", [8, 4, 6])
def test_state_dict_resumes_the_sample_cursor(new_batch):
    """Resume at the saved global sample cursor: the same batch size
    continues the stream; another one lands on the same sample (or the
    next batch boundary, as JAX's loader does, when it does not divide
    the cursor)."""
    from deepspeed_tpu.runtime.dataloader import (
        RepeatingLoader as JaxRepeating)
    data = TokenDataset(40)
    first = RepeatingLoader(DeepSpeedDataLoader(data, 8, seed=1))
    for _ in range(7):              # into the second epoch
        next(first)
    state = first.state_dict()
    assert state["samples_served"] == 56 and state["epoch"] == 1
    port = RepeatingLoader(DeepSpeedDataLoader(data, new_batch, seed=1))
    port.load_state_dict(state)
    ref = JaxRepeating(_jax_loader(data, new_batch, seed=1))
    ref.load_state_dict(state)
    assert port.state_dict() == ref.state_dict()
    assert port.samples_served >= 56
    for _ in range(5):
        _same(next(port), next(ref))
    if new_batch == 8:
        cont = RepeatingLoader(DeepSpeedDataLoader(data, 8, seed=1))
        for _ in range(7):
            next(cont)
        resumed = RepeatingLoader(DeepSpeedDataLoader(data, 8, seed=1))
        resumed.load_state_dict(state)
        for _ in range(3):
            a, b = next(cont), next(resumed)
            assert all(torch.equal(a[k], b[k]) for k in a)


def test_initialize_returns_the_loader_and_train_batch_pulls_from_it():
    data = TokenDataset(24, t=16)
    model = GPT2LMHead(gpt2_tiny(dtype=torch.float32), device="cpu")
    config = {"train_batch_size": 8, "steps_per_print": 10 ** 9,
              "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}}
    engine, opt, loader, _ = initialize(
        model=model, config=config, device="cpu", training_data=data,
        collate_fn=lambda s: {"input_ids": torch.from_numpy(
            np.stack([x["input_ids"] for x in s])).long()})
    assert opt is None and isinstance(loader, DeepSpeedDataLoader)
    assert loader.batch_size == 8 and len(loader) == 3
    losses = [float(engine.train_batch()) for _ in range(4)]
    assert np.all(np.isfinite(losses))
    assert engine._data_iter.samples_served == 32
    assert engine._data_iter.epoch == 1
    bare = initialize(model=GPT2LMHead(gpt2_tiny(dtype=torch.float32),
                                       device="cpu"),
                      config=config, device="cpu")[0]
    with pytest.raises(ValueError, match="no training_data"):
        bare.train_batch()
