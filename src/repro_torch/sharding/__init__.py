"""The (data, model) layout of the sharded FL server (``cohort``) and the
collectives that cross it (``collectives``)."""
