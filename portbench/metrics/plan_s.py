"""Seconds set-up spent in ``XSpmvPlan.build`` (a build, or a load from
the plan cache) and in moving the plan to the card (``XSpmvPlan.to``),
from the harness's spans around both."""


def read(rec):
    return rec.plan["seconds"] if rec.plan.get("calls") else None
