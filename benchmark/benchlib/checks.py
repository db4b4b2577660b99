"""How a run's outputs are compared with the plain reference, and the
readings the calibration tool takes of the control and of planted faults.

Serving: the widest gap by which a served token's logit lies below the
reference's best at its position (`served_gap_checks`); the control is the
reference in float8, read at each position by the gap of the token it puts
first (`control_gap`). Training: each followed micro-step's loss, the first
update's gradient and the projector's change after the followed updates,
each by its worst leaf (`train_readings`).
"""

from __future__ import annotations

from benchlib.drivers import free_device


def served_gap_checks(ctx, weights, conf, cases, what: str) -> list:
    """Each case (ids, grid, pixels, served tokens) through the reference;
    the worst gap and the tokens compared, each against its limit. The
    cases stay in `ctx.cases` for the calibration tool."""
    from reference.precision import Float32
    from reference.serve import answer_logits, gaps

    worst, served = 0.0, 0
    for ids, grid, pixels, toks in cases:
        lg = answer_logits(weights, conf, ids, grid, pixels, toks, Float32())
        worst = max(worst, float(gaps(lg, toks).max()))
        served += len(toks)
        del lg
    free_device(ctx.device)
    ctx.cases = (weights, cases)
    return [(f"{what}_logit_gap", worst, ctx.limits["served_logit_gap"], "<="),
            (f"{what}_tokens_compared", served, ctx.traffic["check"]["min_tokens"], ">=")]


def control_gap(weights, conf, cases, device) -> float:
    """The control's reading: at each position of the cases' prompts and
    served tokens, the reference's gap of the token the float8 reference
    puts first; the widest."""
    from reference.precision import Float8, Float32
    from reference.serve import answer_logits, gaps

    worst = 0.0
    for ids, grid, pixels, toks in cases:
        ref = answer_logits(weights, conf, ids, grid, pixels, toks, Float32())
        ctl = answer_logits(weights, conf, ids, grid, pixels, toks, Float8())
        worst = max(worst, float(gaps(ref, ctl.argmax(-1).tolist()).max()))
        del ref, ctl
    free_device(device)
    return worst


def train_readings(got: dict, ref: dict) -> dict:
    """The three numbers a training cell compares, of `got` (losses,
    first_grad and change by leaf path) against the float32 reference."""
    from reference import train

    keep = train.kept_leaves(ref["first_grad"])
    return {"loss_rel_gap": max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"])),
            "first_grad_leaf_gap": train.leaf_gap(got["first_grad"], ref["first_grad"], keep),
            "update_leaf_gap": train.leaf_gap(got["change"], ref["change"], keep)}
