"""repro_torch.study — the lazy query-plan layer (port of ``repro.study``).

``Study`` (api) builds a ``Plan`` (plan) of scan/join/predicate/conform/
compact/cohort nodes; predicates are typed ``col()``/``Expr`` trees (expr);
``optimize`` (optimizer) fuses predicate chains, shares scans, defers
compaction and prunes unread columns through the flatten joins; ``execute``
(executor) runs the plan and auto-records ``OperationLog`` provenance.

``normalize`` canonicalizes optimized plans (literal hoisting, stable order,
label stripping) so structurally-equal queries share one runner;
``analyze`` statically verifies plans (``Study.check``), and
``ChunkedExecutor`` (``Study.run_chunked``) runs a study out-of-core over a
partitioned star.
"""
from repro_torch.study.plan import Node, Plan, PlanBuilder
from repro_torch.study.expr import (
    Expr, col, lit, all_of, any_of, expr_from_param, fused_predicate,
    node_predicate, parse_cohort_expr, CohortParseError,
)
from repro_torch.study.optimizer import (
    optimize, merge_projections, fuse_masks, defer_compaction,
    prune_columns, plan_capacities, prune_exchanges, dce, assign_engines,
    available_columns, required_columns,
)
from repro_torch.study.executor import (execute, TRANSFORMS, jit_cache_info,
                                        clear_jit_cache)
from repro_torch.study.api import (
    Study, StudyResult, contribute_flatten, contribute_flatten_sliced,
    flow_rows_from_log, column_audit_from_log,
)
from repro_torch.study.normalize import (
    NormalPlan, normalize, device_params, params_signature, cut_points,
    subgraph_hashes,
)
from repro_torch.study.analyze import (
    Diagnostic, DIAGNOSTIC_CODES, PlanValidationError, analyze, errors,
)
from repro_torch.study.chunked import ChunkedExecutor, ChunkedReport

__all__ = [
    "Node", "Plan", "PlanBuilder",
    "Expr", "col", "lit", "all_of", "any_of", "expr_from_param",
    "fused_predicate", "node_predicate", "parse_cohort_expr",
    "CohortParseError",
    "optimize", "merge_projections", "fuse_masks", "defer_compaction",
    "prune_columns", "plan_capacities", "prune_exchanges", "dce",
    "assign_engines", "available_columns", "required_columns",
    "execute", "TRANSFORMS", "jit_cache_info", "clear_jit_cache",
    "Study", "StudyResult", "contribute_flatten", "contribute_flatten_sliced",
    "flow_rows_from_log", "column_audit_from_log",
    "NormalPlan", "normalize", "device_params", "params_signature",
    "cut_points", "subgraph_hashes",
    "Diagnostic", "DIAGNOSTIC_CODES", "PlanValidationError", "analyze",
    "errors", "ChunkedExecutor", "ChunkedReport",
]
