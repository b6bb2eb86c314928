"""PyTorch port, the expert cache's staging path: back-to-back
``HostExpertStore.fetch`` + ``ExpertCache.insert`` on one thread, over more
batches than the store has staging buffers, with no wait between them.
Batch i + 2 refills batch i's staging buffer, so an insert whose copies had
not read that buffer yet would land another batch's weights in its slots;
``fetch`` waits on the buffer's last copy event first (on the card; on the
CPU every copy is done when ``insert`` returns).  Every slot must hold its
store row.  The on-card counterpart is in tests/test_torch_cuda.py and
chip_smoke.py.

Reduced mixtral in f32 (4 MoE layers of 8 experts), random weights from a
seed."""
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.core import offload
from repro_torch.core.cache import ExpertCache
from repro_torch.core.offload import HostExpertStore
from repro_torch.models.registry import build_model

torch.set_num_threads(1)  # pytest -n: several processes share the cores


@pytest.fixture(scope="module")
def store():
    cfg = get_config("mixtral-8x7b").reduced(dtype="float32")
    return HostExpertStore(cfg, build_model(cfg, "cpu", seed=0))


def _batches(store, per_batch):
    keys = [(l, e) for l in range(store.num_layers)
            for e in range(store.num_experts)]
    return [keys[i:i + per_batch] for i in range(0, len(keys), per_batch)]


@pytest.mark.parametrize("per_batch", [1, 3, 8])
def test_back_to_back_fetch_insert_lands_every_row(store, per_batch):
    batches = _batches(store, per_batch)
    assert len(batches) > offload._NUM_STAGING
    cache = ExpertCache(store.num_layers * store.num_experts,
                        store.buffer_shapes(), torch.float32,
                        table_shape=(store.num_layers, store.num_experts),
                        device="cpu")
    staged = []
    for keys in batches:
        arrays = store.fetch(keys)
        staged.append(arrays["wu"].data_ptr())
        cache.insert(keys, arrays)
    # the ring really is reused: batch i + 2 is staged where batch i was
    assert staged[offload._NUM_STAGING] == staged[0]
    cache.wait()
    assert cache.check_invariants()
    for (l, e), s in cache.table.items():
        for n in store.names:
            assert torch.equal(cache.bufs[n][s], store.expert(n, l, e)), \
                (n, l, e)
    assert len(cache.table) == sum(len(b) for b in batches)
