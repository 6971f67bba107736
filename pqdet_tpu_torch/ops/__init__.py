"""Ops: the kernels with their wrappers and plain versions, and the
plain pre- and post-processing around the forward."""
