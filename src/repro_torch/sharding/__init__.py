"""The (data, model) layout of the sharded FL server (``cohort``) and the
collectives that cross it (``collectives``); the production mesh's
sharding plans for the dry runs (``specs``, ``hints``, ``padding``)."""
