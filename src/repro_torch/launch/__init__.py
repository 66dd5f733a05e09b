"""Entry points of the port: `python -m repro_torch.launch.serve`,
`python -m repro_torch.launch.train` and the dry run,
`python -m repro_torch.launch.dryrun` (every (arch x shape) cell counted
on the meta device; `launch.specs`, `launch.mesh`)."""
