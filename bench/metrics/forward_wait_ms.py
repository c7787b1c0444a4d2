"""forward_wait_ms: host milliseconds a packed step spends in CUDA runtime
calls that block until the card has drained (stream, device and event
synchronizes, synchronous copies and sets: bench/program_trace.py
BLOCKING) inside the program's `repro.forward` span (serve/paged.py
_call_device, around the device seam), over the profiled stretch. Nothing
where the stretch holds no device events or no such span."""
from bench import program_trace


def read(ctx):
    program = program_trace.of(ctx)
    return None if program is None else program.forward_wait_ms
