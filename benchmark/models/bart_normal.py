"""``bart_normal``: a BART regression with Gaussian noise,
``Normal(BART(m, max_depth), HalfNormal(sigma_prior_scale))``; one output,
constant leaves, continuous splits.  Its fits are held to
``reference/check.py``."""

# the numbers of ``correct``: ``reference/<CHECK>.py``
CHECK = "check"
# the posterior draws a fit keeps for the check
DRAWS = ("mu", "sigma")


def build(pmb, config, X, Y):
    """The model on the data ``X``, ``Y``.  Returns ``(model, bart_rv)``."""
    with pmb.Model() as model:
        mu = pmb.BART("mu", X, Y, m=config["m"],
                      max_depth=config["max_depth"])
        sigma = pmb.HalfNormal("sigma", config["sigma_prior_scale"])
        pmb.Normal("y", mu, sigma, observed=Y)
    return model, mu
