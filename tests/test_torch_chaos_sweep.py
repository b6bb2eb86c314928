"""PyTorch port, THE acceptance contract of tests/test_chaos.py on the
port's engine, on the CPU: under the seeded fault schedule (transient
fetch / insert errors, latency spikes, payload corruption, worker kills)
every decode x offload combination commits the port's fault-free greedy
stream, and the resilience counters show the faults were seen.  The
drills' units are in tests/test_torch_chaos.py, whose fixture this file
shares (reduced mixtral in f32 with the reference's weights)."""
import pytest

from repro_torch.core.chaos import ChaosConfig
from repro_torch.core.engine import DECODE_POLICIES, OFFLOAD_POLICIES
from test_torch_chaos import _engine, _reqs, ms  # noqa: F401 (fixture)

CHAOS = ChaosConfig(seed=7, fetch_error_rate=0.2, insert_error_rate=0.05,
                    spike_rate=0.05, spike_s=0.001, corrupt_rate=0.1,
                    kill_worker_every=5)


@pytest.mark.parametrize("offload", OFFLOAD_POLICIES)
@pytest.mark.parametrize("decode", DECODE_POLICIES)
def test_chaos_serving_lossless_all_combinations(ms, decode, offload):
    """Two concurrent sessions on a tight cache still commit exactly the
    fault-free greedy reference streams, on every decode x offload
    combination.  Retries, checksum quarantine and the degradation ladder
    absorb every injected fault — latency is the only permitted
    casualty."""
    _, _, _, _, prompts, refs = ms
    with _engine(ms, decode=decode, offload=offload, slots=8,
                 max_draft_len=5, chaos=CHAOS) as eng:
        res = eng.serve_all(_reqs(prompts), concurrency=2)
    for r, ref in zip(res, refs):
        assert r.tokens == ref, (decode, offload)
        assert r.finish_reason == "length"


def test_chaos_counters_surface_detection(ms):
    """The resilience counters in counters() / Metrics actually move under
    injection — detection is observable, not silent — and the checksum
    verifier catches every injected corruption."""
    _, _, _, _, prompts, refs = ms
    with _engine(ms, slots=8, chaos=CHAOS) as eng:
        res = eng.serve_all(_reqs(prompts), concurrency=2)
        c = eng.runtime.counters()
        inj = eng.runtime.chaos.injected
    assert [r.tokens for r in res] == refs
    assert inj["fetch_errors"] > 0          # the schedule actually fired
    assert c["prefetch_retries"] > 0 or c["prefetch_errors"] > 0
    # every injected corruption was caught by checksum verification —
    # none can have reached the device cache
    assert c["checksum_failures"] >= inj["corruptions"]
    assert c["io_errors"] == 0              # injected faults never escalate
    for k in ("prefetch_errors", "prefetch_retries", "checksum_failures",
              "worker_restarts", "degraded_rounds", "io_errors"):
        assert res[0].metrics[k] >= 0       # ledger carries the new keys
