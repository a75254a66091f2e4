"""``bart_bernoulli``: the BART classifier ``Bernoulli(p=sigmoid(BART(m,
max_depth)))``; one output, constant leaves, continuous splits, no free
parameter besides the forest (so no NUTS step).  Its fits are held to
``reference/check_bernoulli.py``."""

# the numbers of ``correct``: ``reference/<CHECK>.py``
CHECK = "check_bernoulli"
# the posterior draws a fit keeps for the check: the logit
DRAWS = ("lo",)


def build(pmb, config, X, Y):
    """The model on the data ``X``, labels ``Y``.  Returns ``(model,
    bart_rv)``."""
    with pmb.Model() as model:
        lo = pmb.BART("lo", X, Y, m=config["m"],
                      max_depth=config["max_depth"])
        pmb.Bernoulli("y", p=pmb.math.sigmoid(lo), observed=Y)
    return model, lo
