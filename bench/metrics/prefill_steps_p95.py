"""prefill_steps_p95: the p95, over the requests whose first token lands
in the traced run's window (those ttft_p95_ms counts), of the packed steps
from a request's admission to its first token, both ends counted
(serve/paged.py stamps Request.admit_step and first_token_step). The loop
is closed and step-synchronous, so the count does not depend on the
card's pace: it moves with scheduling alone. Nothing where the program
stamps no steps."""
from bench import program_trace


def read(ctx):
    program = program_trace.of(ctx)
    return None if program is None else program.prefill_steps_p95
