from repro_torch.data.synthetic import (RetrievalDataset,
                                        make_mixed_difficulty_h,
                                        make_retrieval_dataset)

__all__ = ["RetrievalDataset", "make_retrieval_dataset",
           "make_mixed_difficulty_h"]
