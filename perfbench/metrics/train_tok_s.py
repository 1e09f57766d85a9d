"""train_tok_s: tokens of every train step completed in the window, over
the window's seconds; host clock."""


def read(rec):
    if "steps" not in rec or "seq_len" not in rec:
        return None
    return rec["steps"] * rec["batch"] * rec["seq_len"] / rec["window_s"]
