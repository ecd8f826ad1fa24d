"""Model families (dense slice: ``models.transformer``, ``models.registry``)."""
