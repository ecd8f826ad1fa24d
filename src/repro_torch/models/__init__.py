"""Model families: the dense decoder (``models.transformer``), RWKV-6
(``models.rwkv``) and the uniform API over them (``models.registry``)."""
