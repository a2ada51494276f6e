"""Data loading: this process's micro-batches of the dataset.

Port of deepspeed_tpu/runtime/dataloader.py (reference
deepspeed/runtime/dataloader.py: DeepSpeedDataLoader with its
DistributedSampler :33, RepeatingLoader :10). Each process of a
data-parallel world reads its own disjoint share of a torch Dataset
(``DistributedSampler`` over rank and world) and feeds it as its local
micro-batch; the engine's loss and gradients are the global batch's.
"""
import torch.utils.data as tud


class RepeatingLoader:
    """Wrap an iterator to restart automatically when exhausted
    (reference dataloader.py:10-30)."""

    def __init__(self, loader):
        self.loader = loader
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            batch = next(self.data_iter)
        except StopIteration:
            self.data_iter = iter(self.loader)
            batch = next(self.data_iter)
        return batch


class DeepSpeedDataLoader:
    """Iterates a dataset in micro-batches for this process.

    A torch Dataset gets a DataLoader whose sampler is a
    ``DistributedSampler`` over the data-parallel ranks (a
    ``RandomSampler`` in a world of one), unless ``data_sampler`` is
    given; any other iterable is consumed as it is. len() is the number
    of micro-batches per epoch."""

    def __init__(self, dataset, batch_size, pin_memory=False, local_rank=0,
                 tput_timer=None, collate_fn=None, num_local_io_workers=0,
                 data_sampler=None, data_parallel_world_size=1,
                 data_parallel_rank=0):
        self.batch_size = batch_size
        self.tput_timer = tput_timer
        self.data_sampler = data_sampler
        if isinstance(dataset, tud.Dataset):
            if data_sampler is None:
                if data_parallel_world_size > 1:
                    data_sampler = tud.distributed.DistributedSampler(
                        dataset, num_replicas=data_parallel_world_size,
                        rank=data_parallel_rank)
                else:
                    data_sampler = tud.RandomSampler(dataset)
            self.data_sampler = data_sampler
            self._src = tud.DataLoader(
                dataset, batch_size=batch_size, sampler=data_sampler,
                collate_fn=collate_fn, num_workers=num_local_io_workers,
                pin_memory=pin_memory)
            self.len = len(self._src)
        else:
            self._src = dataset
            try:
                self.len = len(dataset)
            except TypeError:
                self.len = 0

    def __len__(self):
        return self.len

    def __iter__(self):
        if self.tput_timer:
            self.tput_timer.start()
        return iter(self._src)
