"""Each device's collective wire bytes of a step, counted in closed form
from the partition specs (the counterpart of the reference's
``hlo_parse.py``, which reads them off XLA's partitioned HLO; torch has
no HLO, so the schedule below is this module's own).

Every collective's wire bytes are its payload times the reference's
ring egress factor (``repro.roofline.analysis._FACTORS``), with n the
devices of the axes it runs over:

  all-reduce      2(n-1)/n × payload
  all-gather       (n-1)/n × payload   (payload: the gathered tensor)
  reduce-scatter    (n-1)  × payload   (payload: a device's shard of it)
  all-to-all       (n-1)/n × payload

``T`` below is the tokens a device holds: batch × sequence (the prefix
slots of a VLM included; one token a sequence at decode) over the
batch's shards; ``d`` the model width; activations are bf16 (2 bytes).

1. Tensor parallelism: one all-reduce of a block's output, T × d × 2
   bytes over ``model``, after each mixer and each dense FFN (an MoE
   layer's shared-expert MLP included) whose output projection (``wo``,
   ``w_out``, ``out_proj``, ``w_down``) is sharded on its input dim;
   ``mamba`` has no FFN, so one a layer.
2. MoE, a layer whose experts are split over an axis (a device that
   holds every expert, as under ``dp_only``, exchanges none), by
   ``cfg.moe_impl``:
   ``a2a``: two all-to-alls over ``model`` (dispatch and combine) of the
   routed rows, T × k × d × 2 bytes each;
   ``eshard``: one all-reduce over ``model`` of the (T, d) output;
   ``scatter`` (the default): one all-reduce over the data axes of the
   (E_local, C, d) dispatch buffer, E_local the experts a device holds
   and C the rows of its sequences (the streaming capacity of the
   sequence length a sequence, one row a sequence at decode).
3. Each pass counts once at prefill and decode; a train step counts 1
   and 2 three times under block remat (forward, the re-forward,
   backward) and twice otherwise (``save_mixer_ffn`` saves the outputs
   after the collectives).
4. Train only, the gradient sync, leaf by leaf, of a device's gradient
   bytes G (its params' model-axis shard, in the params' dtypes; float32
   with ``grad_accum`` > 1, the port's averaged microbatch gradients):
   a leaf whose param spec holds data axes (``fsdp``): one
   reduce-scatter of G over them; else a leaf whose moments' spec
   (``opt_pspec``) holds data axes (``zero1``): one reduce-scatter of G
   and one all-gather of the updated param (its model-axis shard in its
   dtype) over them; every other leaf: one all-reduce of G over the
   axes the batch is split on, all such leaves together (``tp``; under
   ``dp_only`` the batch is split over every axis and no param over
   "model", so that is one all-reduce of the whole gradient over all
   the devices, and rule 1 adds nothing).
5. ``fsdp``: a leaf whose param spec holds data axes is all-gathered
   over them (its model-axis shard) before each pass of rule 3: a
   stacked leaf a layer at a time (its bytes over ``repeats``), the
   layer's leaves in one all-gather, ``repeats`` × passes times; the
   embedding and the final norm once a forward and once a backward
   (no re-forward).
6. Time: each collective's wire bytes over the link its group runs on
   (``HardwareSpec.group_bw``).  Devices are numbered row-major over the
   mesh, so a group over axes whose outermost one reaches at most
   ``node_size`` consecutive devices (``launch.mesh.axis_span``) stays
   on NVLink inside one node; any wider group crosses nodes at the
   inter-node rate.  On the 16 x 16 and 2 x 16 x 16 meshes every group
   is wider than a node of 8.

Pure arithmetic on shapes and specs: it runs on meta tensors.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Mapping, Tuple

from ..launch.mesh import H100_SXM, axis_span
from ..models.blocks import _parse
from ..models.common import ModelConfig, pspec_leaves, tree_leaves
from ..models.moe import moe_stream_capacity_host

__all__ = ["CollectiveStats", "collective_stats", "spec_shards",
           "FACTORS"]

FACTORS = {
    "all-reduce": lambda n: 2.0 * (n - 1) / max(n, 1),
    "all-gather": lambda n: (n - 1) / max(n, 1),
    "reduce-scatter": lambda n: float(n - 1),
    "all-to-all": lambda n: (n - 1) / max(n, 1),
}
_OUT_PROJ = {"gqa": "wo", "mla": "wo", "rec": "w_out", "mamba": "out_proj"}


@dataclass
class CollectiveStats:
    counts: Dict[str, int] = field(default_factory=dict)
    payload_bytes: Dict[str, float] = field(default_factory=dict)
    wire_bytes: Dict[str, float] = field(default_factory=dict)
    by_rule: Dict[str, float] = field(default_factory=dict)
    seconds: float = 0.0

    @property
    def total_wire_bytes(self) -> float:
        return sum(self.wire_bytes.values())

    def add(self, op: str, rule: str, payload: float, n: int, times: int,
            bw: float) -> None:
        """``times`` collectives ``op`` of ``payload`` bytes over ``n``
        devices (none over one device), at ``bw`` bytes/s."""
        if n <= 1 or times <= 0 or payload <= 0:
            return
        wire = payload * FACTORS[op](n) * times
        self.seconds += wire / bw
        self.counts[op] = self.counts.get(op, 0) + times
        self.payload_bytes[op] = self.payload_bytes.get(op, 0.0) \
            + payload * times
        self.wire_bytes[op] = self.wire_bytes.get(op, 0.0) + wire
        self.by_rule[rule] = self.by_rule.get(rule, 0.0) + wire

    def to_dict(self) -> Dict:
        return {"counts": self.counts, "payload_bytes": self.payload_bytes,
                "wire_bytes": self.wire_bytes, "by_rule": self.by_rule,
                "total_wire_bytes": self.total_wire_bytes,
                "seconds": self.seconds}


def spec_shards(entry, sizes: Mapping[str, int]) -> int:
    """Devices one spec entry splits a dim over."""
    if entry is None:
        return 1
    n = 1
    for name in (entry if isinstance(entry, tuple) else (entry,)):
        n *= sizes[name]
    return n


def _on_model(entry) -> bool:
    return entry == "model" or (isinstance(entry, tuple) and "model" in entry)


def _data_axes(spec) -> Tuple[str, ...]:
    """The axes other than "model" that a spec splits any dim over."""
    out = ()
    for entry in spec:
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            if name is not None and name != "model":
                out += (name,)
    return out


def _model_shard_bytes(spec, leaf, n_model: int, itemsize=None) -> float:
    """Bytes of a leaf's model-axis shard (the data axes not split)."""
    shard = 1
    for entry in spec:
        if _on_model(entry):
            shard *= n_model
    return leaf.numel() * (itemsize or leaf.element_size()) / shard


def collective_stats(cfg: ModelConfig, *, kind: str, seq_len: int,
                     global_batch: int, sizes: Mapping[str, int],
                     param_pspec, params, batch_axes: Tuple[str, ...],
                     grad_accum: int = 1, hw=H100_SXM,
                     opt_pspec=None) -> CollectiveStats:
    """The wire bytes and seconds of one step of ``kind`` (train |
    prefill | decode) on a mesh of ``sizes`` (its axes in mesh order),
    by the rules above.  ``param_pspec`` and ``params`` (meta tensors)
    are the model's specs and shapes; ``batch_axes`` the axes the batch
    is split over; ``opt_pspec`` the specs of one moment (the params'
    tree), None where they mirror the params."""
    st = CollectiveStats()
    n_model = sizes.get("model", 1)
    data_axes = tuple(a for a in sizes if a != "model")
    bw_model = hw.group_bw(axis_span(sizes, ("model",))) \
        if "model" in sizes else 0.0
    bw_data = hw.group_bw(axis_span(sizes, data_axes)) if data_axes else 0.0
    batch_shards = 1
    for a in batch_axes:
        batch_shards *= sizes[a]
    seq = 1 if kind == "decode" else seq_len + (
        cfg.prefix_len if cfg.prefix_len > 0 and not cfg.prefix_only else 0)
    b_dev = global_batch // batch_shards
    tokens = b_dev * seq
    act = tokens * cfg.d_model * 2.0
    passes = 1 if kind != "train" else (3 if cfg.remat == "block" else 2)
    n_data = 1
    for name in data_axes:
        n_data *= sizes[name]
    for bg, subs in zip(cfg.blocks, param_pspec["groups"]):
        for kind_, spec in zip(bg.pattern, subs):
            mixer, _, ffn = _parse(kind_)
            reps = bg.repeats * passes
            if _on_model(spec["mixer"][_OUT_PROJ[mixer]][1]):
                st.add("all-reduce", "tp", act, n_model, reps, bw_model)
            if ffn == "dense" and _on_model(spec["ffn"]["w_down"][1]):
                st.add("all-reduce", "tp", act, n_model, reps, bw_model)
            if ffn != "moe":
                continue
            moe = spec["ffn"]
            if "shared" in moe and _on_model(moe["shared"]["w_down"][1]):
                st.add("all-reduce", "tp", act, n_model, reps, bw_model)
            if moe["w_gate"][1] is None:            # every expert local
                continue
            if cfg.moe_impl == "a2a":
                st.add("all-to-all", "moe", act * cfg.experts_per_token,
                       n_model, 2 * reps, bw_model)
            elif cfg.moe_impl == "eshard":
                st.add("all-reduce", "moe", act, n_model, reps, bw_model)
            else:
                e_local = cfg.n_experts // spec_shards(moe["w_gate"][1],
                                                       sizes)
                rows = b_dev * (1 if kind == "decode"
                                else moe_stream_capacity_host(seq, cfg))
                st.add("all-reduce", "moe",
                       e_local * rows * cfg.d_model * 2.0, n_data, reps,
                       bw_data)
    _fsdp_gathers(st, cfg, sizes, param_pspec, params, passes,
                  1 if kind != "train" else 2, hw)
    if kind != "train":
        return st
    leaves = tree_leaves(params)
    specs = pspec_leaves(param_pspec)
    opt_specs = (pspec_leaves(opt_pspec) if opt_pspec is not None
                 else [None] * len(leaves))
    all_reduced = 0.0
    sharded: Dict[Tuple[str, ...], list] = {}    # axes -> [RS, AG] bytes
    for spec, ospec, leaf in zip(specs, opt_specs, leaves):
        g = _model_shard_bytes(spec, leaf, n_model,
                               itemsize=4 if grad_accum > 1 else None)
        axes = _data_axes(spec) or (_data_axes(ospec) if ospec else ())
        if not axes:
            all_reduced += g
            continue
        b = sharded.setdefault(axes, [0.0, 0.0])
        b[0] += g
        if not _data_axes(spec):                 # ZeRO-1: params gathered
            b[1] += _model_shard_bytes(spec, leaf, n_model)
    for axes, (rs, ag) in sharded.items():
        n = math.prod(sizes[a] for a in axes)
        bw = hw.group_bw(axis_span(sizes, axes))
        st.add("reduce-scatter", "dp", rs / n, n, 1, bw)
        st.add("all-gather", "zero1", ag, n, 1, bw)
    if batch_axes:
        st.add("all-reduce", "dp", all_reduced, batch_shards, 1,
               hw.group_bw(axis_span(sizes, batch_axes)))
    return st


def _fsdp_gathers(st: CollectiveStats, cfg: ModelConfig, sizes, param_pspec,
                  params, passes: int, top_passes: int, hw) -> None:
    """Rule 5: the all-gathers of the params an FSDP plan splits over data
    axes (none under any other plan)."""
    n_model = sizes.get("model", 1)

    def gather(spec_tree, leaf_tree, per: int, times: int) -> None:
        by_axes: Dict[Tuple[str, ...], float] = {}
        for spec, leaf in zip(pspec_leaves(spec_tree),
                              tree_leaves(leaf_tree)):
            axes = _data_axes(spec)
            if axes:
                by_axes[axes] = by_axes.get(axes, 0.0) + \
                    _model_shard_bytes(spec, leaf, n_model) / per
        for axes, payload in by_axes.items():
            st.add("all-gather", "fsdp", payload,
                   math.prod(sizes[a] for a in axes), times,
                   hw.group_bw(axis_span(sizes, axes)))

    for bg, specs, leaves in zip(cfg.blocks, param_pspec["groups"],
                                 params["groups"]):
        for spec, leaf in zip(specs, leaves):
            gather(spec, leaf, bg.repeats, bg.repeats * passes)
    gather({k: v for k, v in param_pspec.items() if k != "groups"},
           {k: v for k, v in params.items() if k != "groups"}, 1, top_passes)
