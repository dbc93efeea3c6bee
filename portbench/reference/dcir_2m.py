"""Plain reference of the configuration ``dcir_2m``: the SNDS DCIR star
(ER_PRS cash flows, ER_PHA and ER_CAM detail tables, IR_BEN patients).

``prepare`` takes the generated star, as the program gets it, and flattens
it once, the plain way; ``answer`` gives what one query must produce: its
event tables (valid rows in order), cohorts (membership masks), flow
counts and the flatten's stats.  With ``control``, every int32 column is
int16 first: the integer width below the configuration's int32 (ids wrap and
collide), which the comparison must catch.
"""
from __future__ import annotations

from portbench.reference import plain as p

DCIR_JOINS = (("ER_PHA", "flow_id", "flow_id", False),
              ("ER_CAM", "flow_id", "flow_id", False),
              ("IR_BEN", "patient_id", "patient_id", False))


class State:
    def __init__(self, star, n_patients: int, control: bool = False):
        self.star = p.as_int16(star) if control else star
        self.n_patients = int(n_patients)
        self.flat, self.stats = p.flatten(self.star, "ER_PRS", DCIR_JOINS)


def prepare(star, cfg, control: bool = False) -> State:
    return State(star, cfg["n_patients"], control)


def _drugs(s: State, codes=None):
    return p.extract(s.flat, p.DRUG_DISPENSE, "cip13", "execution_date",
                     null_cols=("cip13",), codes=codes)


def _acts(s: State, codes=None):
    return p.extract(s.flat, p.MEDICAL_ACT, "ccam_code", "execution_date",
                     null_cols=("ccam_code",), codes=codes)


def _answer(s: State, events, cohorts, flow=None):
    return {"events": events, "cohorts": cohorts, "flow": flow,
            "flatten_stats": [dict(x) for x in s.stats], "features": {},
            "feature_checks": {}, "unordered": ()}


def quickstart(s: State, q):
    drugs = _drugs(s, q["drug_codes"])
    acts = _acts(s, q["act_codes"])
    pats = p.patients(s.star["IR_BEN"])
    P = s.n_patients
    base, drugged = p.subjects(pats["patient_id"], P), p.subjects(
        drugs["patient_id"], P)
    final = drugged & base & ~p.subjects(acts["patient_id"], P)
    return _answer(s, {"drug_purchases": drugs, "acts": acts,
                       "extract_patients": pats},
                   {"base": base, "drugged": drugged, "final": final},
                   p.flow([base, drugged, final]))


SHAPES = {"quickstart": quickstart}


def answer(s: State, q):
    return SHAPES[q["shape"]](s, q)
