from repro_torch.data.synthetic import (
    clustered_images,
    make_lm_batch,
    lm_batches,
    TicketDataLoader,
)

__all__ = ["clustered_images", "make_lm_batch", "lm_batches",
           "TicketDataLoader"]
