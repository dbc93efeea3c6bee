"""The paper's cohort study, tasks (a)-(g) (the program's side).

``examples/cohort_study.py``'s plan over the flat DCIR and PMSI-MCO tables
and IR_BEN: patients, dispenses, prevalent drugs of the drawn ATC classes,
acts (outpatient and hospital), diagnoses, stays, exposures with the drawn
purview, fractures with the drawn act and diagnosis codes, follow-up, the
cohort algebra ``(exposed & base) - fractured``, the flow, and both
featurizes: dense ``(36, 31, 128)`` and tokens at ``seq_len`` 256."""

STUDY_END = 14_600 + 3 * 365


def build(q, n_patients: int):
    from repro_torch.core import (diagnoses, drug_dispenses, hospital_stays,
                                  medical_acts_dcir, medical_acts_pmsi)
    from repro_torch.study import Study, col

    end = STUDY_END
    return (Study(n_patients=n_patients, window=(14_600, end))
            .patients("IR_BEN")
            .extract(drug_dispenses(), name="drug_purchases")
            .extract(drug_dispenses()
                     .filtered(col("atc_class").isin(q["atc_classes"])
                               & col("execution_date").between(14_600, end)),
                     name="prevalent_drugs")
            .extract(medical_acts_dcir(), name="acts")
            .extract(medical_acts_pmsi(), name="hospital_acts")
            .extract(diagnoses(), name="diagnoses")
            .extract(hospital_stays(), name="stays")
            .transform("exposures", "drug_purchases", name="exposures",
                       purview_days=q["purview_days"])
            .concat("all_acts", "acts", "hospital_acts")
            .transform("fractures", "all_acts", "diagnoses", name="fractures",
                       fracture_act_codes=q["fracture_acts"],
                       fracture_diag_codes=q["fracture_diags"])
            .transform("follow_up", "extract_patients", "drug_purchases",
                       name="follow_up", study_end=end)
            .cohort("base", "extract_patients")
            .cohort("exposed", "exposures")
            .cohort("fractured", "fractures")
            .cohort("final", "(exposed & base) - fractured")
            .flow("base", "exposed", "final")
            .featurize("X", cohort="final", kind="dense",
                       n_buckets=36, bucket_days=31, n_features=128)
            .featurize("tokens", cohort="final", kind="tokens", seq_len=256))
