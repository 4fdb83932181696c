"""Power flow: Newton-Raphson (``ac``, and on the BBD substrate
``newton_bbd``), fast decoupled (``fast_decoupled``, dense and BBD),
Gauss-Seidel (``gauss_seidel``), DC (``dc``), reactive limits (``limits``)
and the driver (``driver``)."""
