from learningorchestra_tpu_torch.viz.service import (  # noqa: F401
    ImageService, create_embedding_image, embed_dataset)
