"""How the port builds a model of each family (``families/<name>.py``).

A family module gives the port's raw model for a configuration
(:func:`port_model`), the names and shapes of its parameters
(``top_spec`` / ``layer_spec`` / ``layer_prefix``, read by ``weights.py``)
and its shapes for ``work/`` (``linears`` and ``heads``)."""
