"""prefill_tokens_per_s.serve: prompt tokens the engine prefilled over the
seconds its prefills took, in the window (the engine's ``prefill_tokens``
and ``prefill_seconds`` counters, each prefill timed until its first tokens
reach the host)."""


def read(ctx):
    s = ctx["layer"].get("stats")
    if not s or s.get("prefill_seconds", 0) <= 0:
        return None
    return s["prefill_tokens"] / s["prefill_seconds"]
