"""Training data pipeline: datasets, augmentation, batching (counterpart of
sesa_tpu/data/ and of the reference's models/bandit/core/data/): numpy on
the host, one batch upload per train step."""

from sesa_tpu_torch.data.augmentation import (AUGMENTATIONS, StemAugmentor,
                                              build_augmentation)
from sesa_tpu_torch.data.datasets import (DnRDataset, DnRDeterministicChunkDataset,
                                          DnRRandomChunkDataset,
                                          DnRRandomChunkDatasetWithSpeechReverb,
                                          MUSDB18FullTrackDataset, MUSDB18SadDataset,
                                          MUSDB18SadOnTheFlyAugmentedDataset,
                                          SourceSeparationDataset, batch_iterator)

__all__ = [
    "AUGMENTATIONS", "StemAugmentor", "build_augmentation",
    "SourceSeparationDataset", "MUSDB18FullTrackDataset",
    "MUSDB18SadDataset", "MUSDB18SadOnTheFlyAugmentedDataset",
    "DnRDataset", "DnRRandomChunkDataset", "DnRDeterministicChunkDataset",
    "DnRRandomChunkDatasetWithSpeechReverb", "batch_iterator",
]
