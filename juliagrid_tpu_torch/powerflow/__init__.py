"""Power flow: Newton-Raphson (``ac``) and its driver (``driver``)."""
