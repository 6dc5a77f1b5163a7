"""The multi-device layer of the port, on torch.distributed.

Counterpart of optimalcontrolmps_tpu/parallel: `mesh` (process groups laid
out as a ("batch", "rows") mesh, this rank's shards), `comm` (the explicit
collectives), `multistart` (the sharded multistart L-BFGS and train step),
`dryrun` (the four multi-device paths at tiny shapes) and `spawn` (a world
of ranks on one host). Import the submodules; this package imports none of
them, so the engines can use `mesh` and `comm` without a cycle.
"""
