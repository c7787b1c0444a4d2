# engine.py     — wave scheduler: same-length prompt batches, lockstep
#                 decode; the request type and greedy sampling
# continuous.py — slot arena: continuous batching with per-slot lengths
# paged.py      — block pool + block tables: paged KV with chunked prefill
#                 (packed token steps by default; lockstep via packed=False)
from repro_torch.serve.continuous import ContinuousEngine
from repro_torch.serve.engine import Request, ServeEngine, sample_tokens
from repro_torch.serve.paged import (BlockAllocator, BlockPoolExhausted,
                                     PagedEngine, pack_slot_ids,
                                     packed_write_positions,
                                     schedule_step_tokens)
