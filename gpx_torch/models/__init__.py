"""GP models of the port (``gp``: marginal likelihood and its gradient)."""
