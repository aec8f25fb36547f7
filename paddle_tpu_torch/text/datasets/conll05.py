"""CoNLL-2005 SRL dataset (text/datasets/conll05.py parity).

Format: conll05st-release tar with test.wsj words/props gzip members;
label sequences reconstructed from the bracketed proposition format to
B-/I-/O tags; per-sample features are the 9-slot SRL layout (word,
predicate context windows, region mark, predicate, labels).
"""
from __future__ import annotations

import gzip
import tarfile

import numpy as np

from ...io import Dataset
from ...dataset.common import _check_exists_and_download

DATA_URL = "https://dataset.bj.bcebos.com/conll05st%2Fconll05st-tests.tar.gz"
DATA_MD5 = "387719152ae52d60422c016e92a742fc"
WORDDICT_URL = "https://dataset.bj.bcebos.com/conll05st%2FwordDict.txt"
WORDDICT_MD5 = "ea7fb7d4c75cc6254716f0177a506baa"
VERBDICT_URL = "https://dataset.bj.bcebos.com/conll05st%2FverbDict.txt"
VERBDICT_MD5 = "0d2977293bbb6cbefab5b0f97db1e77c"
TRGDICT_URL = "https://dataset.bj.bcebos.com/conll05st%2FtargetDict.txt"
TRGDICT_MD5 = "d8c7f03ceb5fc2e5a0fa7503a4353751"
EMB_URL = "https://dataset.bj.bcebos.com/conll05st%2Femb"
EMB_MD5 = "bf436eb0faa1f6f9103017f8be57cdb7"

UNK_IDX = 0


class Conll05st(Dataset):
    def __init__(self, data_file=None, word_dict_file=None,
                 verb_dict_file=None, target_dict_file=None, emb_file=None,
                 download=True):
        self.data_file = _check_exists_and_download(
            data_file, DATA_URL, DATA_MD5, "conll05st", download)
        self.word_dict_file = _check_exists_and_download(
            word_dict_file, WORDDICT_URL, WORDDICT_MD5, "conll05st",
            download)
        self.verb_dict_file = _check_exists_and_download(
            verb_dict_file, VERBDICT_URL, VERBDICT_MD5, "conll05st",
            download)
        self.target_dict_file = _check_exists_and_download(
            target_dict_file, TRGDICT_URL, TRGDICT_MD5, "conll05st",
            download)
        self.word_dict = self._load_dict(self.word_dict_file)
        self.predicate_dict = self._load_dict(self.verb_dict_file)
        self.label_dict = self._load_label_dict(self.target_dict_file)
        self._load_anno()

    @staticmethod
    def _load_dict(path):
        d = {}
        with open(path, "r") as f:
            for i, line in enumerate(f):
                d[line.strip()] = i
        return d

    @staticmethod
    def _load_label_dict(path):
        d = {}
        tag_dict = set()
        with open(path, "r") as f:
            for line in f:
                line = line.strip()
                if line.startswith("B-"):
                    tag_dict.add(line[2:])
                elif line.startswith("I-"):
                    tag_dict.add(line[2:])
        index = 0
        for tag in sorted(tag_dict):
            d["B-" + tag] = index
            index += 1
            d["I-" + tag] = index
            index += 1
        d["O"] = index
        return d

    def _parse_labels(self, labels):
        """Bracketed proposition columns -> per-predicate B/I/O tag seqs."""
        outs = []
        verb_list = [x for x in labels[0] if x != "-"]
        for i, lbl in enumerate(labels[1:]):
            cur_tag, in_bracket = "O", False
            seq = []
            for tok in lbl:
                if tok == "*" and not in_bracket:
                    seq.append("O")
                elif tok == "*" and in_bracket:
                    seq.append("I-" + cur_tag)
                elif tok == "*)":
                    seq.append("I-" + cur_tag)
                    in_bracket = False
                elif "(" in tok and ")" in tok:
                    cur_tag = tok[1:tok.find("*")]
                    seq.append("B-" + cur_tag)
                    in_bracket = False
                elif "(" in tok and ")" not in tok:
                    cur_tag = tok[1:tok.find("*")]
                    seq.append("B-" + cur_tag)
                    in_bracket = True
            outs.append((verb_list[i] if i < len(verb_list) else "-", seq))
        return outs

    def _load_anno(self):
        self.sentences = []
        self.predicates = []
        self.labels = []
        with tarfile.open(self.data_file) as tf:
            wf = tf.extractfile(
                "conll05st-release/test.wsj/words/test.wsj.words.gz")
            pf = tf.extractfile(
                "conll05st-release/test.wsj/props/test.wsj.props.gz")
            with gzip.GzipFile(fileobj=wf) as words_file, \
                    gzip.GzipFile(fileobj=pf) as props_file:
                sentences = []
                one_seg = []
                for word, label in zip(words_file, props_file):
                    word = word.strip().decode("utf-8")
                    label = label.strip().decode("utf-8").split()
                    if len(label) == 0:  # sentence end
                        labels = []
                        for i in range(len(one_seg[0]) if one_seg else 0):
                            labels.append([x[i] for x in one_seg])
                        if len(labels) >= 1:
                            for verb, seq in self._parse_labels(labels):
                                if len(seq) != len(sentences):
                                    continue
                                self.sentences.append(list(sentences))
                                self.predicates.append(verb)
                                self.labels.append(seq)
                        sentences = []
                        one_seg = []
                    else:
                        sentences.append(word)
                        one_seg.append(label)

    def __getitem__(self, idx):
        """The 9-slot SRL feature layout (dataset/conll05.py reader_creator
        parity): word ids, 5 predicate-context windows, region mark,
        predicate id, label ids."""
        sen = self.sentences[idx]
        pred = self.predicates[idx]
        seq = self.labels[idx]
        word_ids = [self.word_dict.get(w, UNK_IDX) for w in sen]
        # predicate context window of 5 around the first B-V
        try:
            verb_index = seq.index("B-V")
        except ValueError:
            verb_index = 0
        ctx = []
        for off in (-2, -1, 0, 1, 2):
            j = min(max(verb_index + off, 0), len(sen) - 1)
            ctx.append(self.word_dict.get(sen[j], UNK_IDX))
        mark = [1 if v == "B-V" or v == "I-V" else 0 for v in seq]
        pred_id = self.predicate_dict.get(pred, UNK_IDX)
        label_ids = [self.label_dict.get(t, self.label_dict["O"])
                     for t in seq]
        return (np.array(word_ids), np.array([ctx[0]] * len(sen)),
                np.array([ctx[1]] * len(sen)),
                np.array([ctx[2]] * len(sen)),
                np.array([ctx[3]] * len(sen)),
                np.array([ctx[4]] * len(sen)), np.array(mark),
                np.array([pred_id]), np.array(label_ids))

    def __len__(self):
        return len(self.sentences)

    def get_dict(self):
        return self.word_dict, self.predicate_dict, self.label_dict

    def get_embedding(self, emb_file=None):
        emb_file = _check_exists_and_download(
            emb_file, EMB_URL, EMB_MD5, "conll05st", emb_file is None)
        return np.loadtxt(emb_file)
