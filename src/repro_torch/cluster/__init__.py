"""The cluster runtime of the port: joining a `torch.distributed` job
(`runtime`).  The local launcher, the worker, fault injection, reports and
the CLI are ROADMAP queue 1, item 10."""
