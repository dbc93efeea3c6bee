"""The quickstart study from the raw DCIR star (the program's side).

Flatten the star (three joins), drug dispenses with a CIP13 whitelist,
medical acts with a CCAM whitelist, the patient table, the cohort algebra
``drugged & base - acts`` and the flow over base, drugged and final.
``q`` carries the drawn literals: ``drug_codes`` and ``act_codes``."""


def build(q, n_patients: int):
    from repro_torch.core import DCIR_SCHEMA, drug_dispenses, medical_acts_dcir
    from repro_torch.study import Study

    return (Study(n_patients=n_patients)
            .flatten(DCIR_SCHEMA)
            .extract(drug_dispenses(codes=q["drug_codes"]),
                     name="drug_purchases")
            .extract(medical_acts_dcir(codes=q["act_codes"]), name="acts")
            .patients("IR_BEN")
            .cohort("base", "extract_patients")
            .cohort("drugged", "drug_purchases")
            .cohort("final", "drugged & base - acts")
            .flow("base", "drugged", "final"))
