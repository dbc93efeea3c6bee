"""SCALPEL3 core in PyTorch: tables, flattening, extraction, transformers,
cohorts, statistics and the FeatureDriver."""
from repro_torch.core.columnar import (ColumnarTable, NULL_INT, NULL_FLOAT,
                                       is_null, resolve_device)
from repro_torch.core.schema import (
    DCIR_SCHEMA, PMSI_MCO_SCHEMA, SSR_SCHEMA, HAD_SCHEMA, IR_IMB_SCHEMA,
    StarSchema, TableSchema, JoinEdge,
)
from repro_torch.core.events import Category, make_events, sort_events
from repro_torch.core.flattening import (
    flatten_star, flatten_sliced, distributed_flatten, lookup_join,
    expand_join, exchange, hash_partition, FlatteningStats,
)
from repro_torch.core.extraction import (
    Extractor, drug_dispenses, medical_acts_dcir, medical_acts_pmsi, diagnoses,
    hospital_stays, patients, dedupe_by, biology_acts,
    practitioner_encounters, csarr_acts, ssr_stays, takeover_reasons,
    long_term_diseases,
)
from repro_torch.core.transformers import (
    observation_period, follow_up, trackloss, exposures, exposures_sharded,
    fractures,
    drug_prescriptions, drug_interactions, bladder_cancer, infarctus,
    heart_failure,
)
from repro_torch.core.cohort import Bitset, Cohort, CohortCollection, CohortFlow
from repro_torch.core.metadata import OperationLog, git_hash
from repro_torch.core.feature_driver import FeatureDriver, TokenizerSpec
from repro_torch.core import stats
