"""Tiny sizes of each configuration and traffic mix for the CPU tests:
every width cut, the shapes' kinds kept."""

MODELS = {
    "mamba2-780m": {"n_layers": 2, "d_model": 64, "vocab_size": 512,
                    "ssm_state": 16, "ssm_head_dim": 16, "ssm_chunk": 8},
    "internvl2-26b": {"n_layers": 2, "d_model": 64, "vocab_size": 512,
                      "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
                      "d_ff": 128, "prefix_len": 6},
}

TRAFFIC = {
    "serve": {"batch": 2, "prompt_len": 12, "new_tokens": 5, "pool": 2},
    "grad_sync": {"seq_len": 16, "bucket": 30000},
    "train": {"seq_len": 16, "pool": 8},
}


def overrides(workload: dict) -> dict:
    tr = dict(TRAFFIC[workload["driver"]])
    model = dict(MODELS[workload["config"]])
    if workload["driver"] == "train":
        # float32 at this size, so the limits set for the cell's bf16
        # at full size hold for a sound run here too
        model["dtype"] = "float32"
    if workload["traffic"].get("prefix_len"):
        tr["prefix_len"] = MODELS[workload["config"]]["prefix_len"]
    return {"model": model, "traffic": tr}
