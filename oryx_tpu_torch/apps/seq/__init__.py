"""Streaming session next-item recommender (the port's copy of
oryx_tpu/apps/seq).

Schema: CSV lines ``user,session,item,ts``. The batch tier windows
session event streams into fixed-length next-item examples and trains a
compact GRU (ops/seq.py); the speed tier folds new/extended sessions into
the item-embedding state as UP row deltas; serving answers
``GET /recommend-next/...`` over the item-embedding matrix through the
shared top-k micro-batcher.
"""
