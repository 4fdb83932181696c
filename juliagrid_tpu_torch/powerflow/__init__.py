"""Power flow: Newton-Raphson (``ac``), fast decoupled (``fast_decoupled``),
Gauss-Seidel (``gauss_seidel``), DC (``dc``), reactive limits (``limits``)
and the driver (``driver``)."""
