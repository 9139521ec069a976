from .lib import (available, apsp, nearest_view, bleu_stats,
                  edit_distance_batch, bucket_by_size, kmeans_lloyd,
                  token_block_slices, block_to_dataset_index)
