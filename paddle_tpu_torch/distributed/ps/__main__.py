"""`python -m paddle_tpu_torch.distributed.ps --port P --trainers N`: a
standalone pserver process (fleet `run_server` / listen_and_serv
entry)."""
import argparse

from . import run_pserver


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--trainers", type=int, default=1)
    ap.add_argument("--optimizer", default="sgd")
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--ready-file", default=None)
    args = ap.parse_args()
    run_pserver(port=args.port, trainers=args.trainers,
                optimizer=args.optimizer, lr=args.lr,
                ready_file=args.ready_file)


if __name__ == "__main__":
    main()
