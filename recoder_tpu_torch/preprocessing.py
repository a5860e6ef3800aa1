"""Dataset preprocessing: the vae-cf strong-generalization protocol.

A copy of ``recoder_tpu/preprocessing.py`` (pandas and numpy; importing
the JAX package's module would import jax). The CSVs it writes are the
JAX module's, byte for byte.

Protocol (reference scripts/ml-20m/preprocess.py:50-106):
  1. binarize / threshold interactions;
  2. filter items with < min_sc users and users with < min_uc items;
  3. hold out ``n_heldout_users`` users each for validation and test
     (the rest train);
  4. for each held-out user, split their items 80/20 into a fold-in
     ("tr") and a held-out ("te") part;
  5. re-index items by training-set appearance, users by the shuffled
     order; write train.csv / {validation,test}_{tr,te}.csv.
"""

import os

import numpy as np
import pandas as pd


def get_count(tp, col):
  return tp[[col]].groupby(col, as_index=False).size().set_index(col)['size']


def filter_triplets(tp, user_col='userId', item_col='movieId',
                    min_uc=5, min_sc=0):
  """Keep items with >= min_sc users, then users with >= min_uc items."""
  if min_sc > 0:
    itemcount = get_count(tp, item_col)
    tp = tp[tp[item_col].isin(itemcount.index[itemcount >= min_sc])]
  if min_uc > 0:
    usercount = get_count(tp, user_col)
    tp = tp[tp[user_col].isin(usercount.index[usercount >= min_uc])]
  usercount, itemcount = get_count(tp, user_col), get_count(tp, item_col)
  return tp, usercount, itemcount


def split_train_test_proportion(data, user_col='userId', test_prop=0.2,
                                seed=98765, min_items=5):
  """Per-user fold-in/held-out split (reference preprocess.py:71-96)."""
  rng = np.random.RandomState(seed)
  tr_list, te_list = [], []
  for _, group in data.groupby(user_col):
    n = len(group)
    if n >= min_items:
      idx = np.zeros(n, dtype=bool)
      idx[rng.choice(n, size=int(test_prop * n),
                     replace=False).astype('int64')] = True
      tr_list.append(group[~idx])
      te_list.append(group[idx])
    else:
      tr_list.append(group)
  return pd.concat(tr_list), pd.concat(te_list)


def strong_generalization_split(raw_data, out_dir, user_col='userId',
                                item_col='movieId', n_heldout_users=10000,
                                min_uc=5, min_sc=0, seed=98765,
                                test_prop=0.2):
  """Run the full protocol and write the six CSVs to ``out_dir``.

  Output files use the reference's uid/sid/watched schema.
  Returns (unique_sid, unique_uid).
  """
  raw_data, user_activity, item_popularity = filter_triplets(
      raw_data, user_col=user_col, item_col=item_col,
      min_uc=min_uc, min_sc=min_sc)

  sparsity = raw_data.shape[0] / (
      user_activity.shape[0] * item_popularity.shape[0])
  print(f'After filtering: {raw_data.shape[0]} events, '
        f'{user_activity.shape[0]} users, {item_popularity.shape[0]} items '
        f'(sparsity {sparsity:.3%})')

  unique_uid = user_activity.index
  rng = np.random.RandomState(seed)
  unique_uid = unique_uid[rng.permutation(unique_uid.size)]

  n_users = unique_uid.size
  tr_users = unique_uid[:(n_users - n_heldout_users * 2)]
  vd_users = unique_uid[(n_users - n_heldout_users * 2):
                        (n_users - n_heldout_users)]
  te_users = unique_uid[(n_users - n_heldout_users):]

  train_plays = raw_data[raw_data[user_col].isin(tr_users)]
  unique_sid = pd.unique(train_plays[item_col])
  show2id = {sid: i for i, sid in enumerate(unique_sid)}
  profile2id = {pid: i for i, pid in enumerate(unique_uid)}

  os.makedirs(out_dir, exist_ok=True)

  def numerize(tp):
    return pd.DataFrame({
        'uid': tp[user_col].map(profile2id).to_numpy(),
        'sid': tp[item_col].map(show2id).to_numpy(),
        'watched': np.ones(len(tp), dtype=np.int8),
    })

  numerize(train_plays).to_csv(os.path.join(out_dir, 'train.csv'),
                               index=False)

  for name, users in (('validation', vd_users), ('test', te_users)):
    plays = raw_data[raw_data[user_col].isin(users)]
    plays = plays[plays[item_col].isin(unique_sid)]
    tr, te = split_train_test_proportion(plays, user_col=user_col,
                                         test_prop=test_prop, seed=seed)
    numerize(tr).to_csv(os.path.join(out_dir, f'{name}_tr.csv'),
                        index=False)
    numerize(te).to_csv(os.path.join(out_dir, f'{name}_te.csv'),
                        index=False)

  print(f'Wrote splits to {out_dir}: {len(tr_users)} train users, '
        f'{len(vd_users)} validation, {len(te_users)} test; '
        f'{len(unique_sid)} items')
  return unique_sid, unique_uid
