"""Rays sharded over ranks of torch.distributed: the render and train steps
(`sharding`), the multi-process render (`distributed`) and its dry run
(`dryrun`); `sharding.train_step` is the train step on one device."""
