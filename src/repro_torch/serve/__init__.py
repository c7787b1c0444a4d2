# engine.py — request type, admission bound, greedy sampling
# paged.py  — block pool + block tables: paged KV with packed token steps
from repro_torch.serve.engine import Request, sample_tokens
from repro_torch.serve.paged import (BlockAllocator, BlockPoolExhausted,
                                     PagedEngine, pack_slot_ids,
                                     packed_write_positions,
                                     schedule_step_tokens)
