"""Every token every model task of a finished request decoded (rows ×
decode tokens a task), over the whole window."""

UNIT = "tokens/s"
LAYER = None
MOVES = None


def read(run):
    tokens = sum(t.rows * t.decode_tokens for r in run.done for t in r.tasks)
    return tokens / run.window_s if tokens else None
