"""Scene builders, one a file, found by a configuration's
scene.builder: scenes/<builder>.py's `make(params, seed)` (and
`reset_pool` where its envs are reset); see core/scene.py."""
