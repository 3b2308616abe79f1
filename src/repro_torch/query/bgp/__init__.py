"""Full BGP engine on the compact form.

The port's copy of ``repro/query/bgp``.  Layers:

* :mod:`algebra`   -- ``StarPattern`` / ``Filter`` / ``BGPQuery`` /
  ``BGPBindings``: multi-star basic graph patterns with range/equality
  filters over dictionary ids.
* :mod:`exec`      -- molecule-granularity execution: deferred subject
  columns, AMI x AMI cross-star joins, vectorized filter pushdown into
  molecule object columns, member materialization last.
* :mod:`planner`   -- the cost model replacing the caller ``strategy=``
  flag: per-star raw-vs-factorized choice (``CostModel`` constants,
  mixed-slot join re-pricing) and greedy connected join ordering from
  AM/AMI ratios and arm/filter selectivities.
* :mod:`calibrate` -- least-squares fit of the ``CostModel`` constants
  from timed workloads (the defaults are the reference's committed
  constants, unchanged, so the planner chooses as it does).
* :mod:`reference` -- the independent semantics oracle used by the
  property tests.

Entry point for callers: ``repro_torch.query.QueryEngine.query_bgp``.
"""
from .algebra import BGPBindings, BGPQuery, Filter, StarPattern, is_var
from .calibrate import calibration_report, fit_cost_model
from .exec import deferral_eligible, execute_bgp
from .planner import BGPPlan, CostModel, StarPlan, plan_bgp
from .reference import eval_bgp_reference

__all__ = [
    "BGPBindings", "BGPQuery", "Filter", "StarPattern", "is_var",
    "deferral_eligible", "execute_bgp",
    "BGPPlan", "CostModel", "StarPlan", "plan_bgp",
    "calibration_report", "fit_cost_model",
    "eval_bgp_reference",
]
