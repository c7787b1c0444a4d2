# engine.py     — wave scheduler: same-length prompt batches, lockstep
#                 decode; the request type and sampling
# continuous.py — slot arena: continuous batching with per-slot lengths
# paged.py      — block pool + block tables: paged KV with chunked prefill
#                 (packed token steps by default; lockstep via packed=False)
# admission.py  — opt-in overload robustness: priority classes, deadlines,
#                 bounded queue + backpressure, preemption policy
# chaos.py      — seeded fault injector + engine invariant checker
# telemetry.py  — request lifecycles, latency percentiles, step phases
# prng.py       — JAX's threefry streams for temperature sampling
from repro_torch.serve.admission import (AdmissionConfig, AdmissionQueue,
                                         QueueFull, RobustnessCounters,
                                         choose_victim)
from repro_torch.serve.chaos import (ChaosMonkey, assert_drained,
                                     check_invariants)
from repro_torch.serve.continuous import ContinuousEngine
from repro_torch.serve.engine import (Request, ServeEngine,
                                      kv_cache_byte_stats, kv_cache_bytes,
                                      sample_tokens)
from repro_torch.serve.paged import (BlockAllocator, BlockPoolExhausted,
                                     PagedEngine, PrefixTrie, pack_slot_ids,
                                     packed_write_positions, prefix_chunk,
                                     schedule_step_tokens)
from repro_torch.serve.telemetry import (MetricsRegistry, RequestTrace,
                                         StepProfiler, Telemetry,
                                         drive_open_loop, format_snapshot,
                                         make_snapshot, percentile)
