"""Roofline terms of the port's plans (port of ``repro.roofline``):
``analytic`` (closed-form FLOPs and HBM bytes, the reference's),
``collectives`` (wire bytes from the partition specs), ``analysis``
(the three terms and the bottleneck) and ``report_md`` (markdown
tables of the records)."""
from .analysis import RooflineReport, model_flops, roofline_report
from .analytic import analytic_terms
from .collectives import CollectiveStats, collective_stats

__all__ = [k for k in dir() if not k.startswith("_")]
