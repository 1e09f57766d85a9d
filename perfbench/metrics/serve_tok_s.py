"""serve_tok_s: tokens generated by every ``generate`` call of the
window, over the window's seconds (its start to the end of its last
call); host clock."""


def read(rec):
    if "calls" not in rec:
        return None
    tokens = len(rec["calls"]) * rec["batch"] * rec["new_tokens"]
    return tokens / rec["window_s"]
