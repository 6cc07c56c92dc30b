"""Run the scanner service on the card: python -m bbocr_tpu_torch.server
[--device cuda] [--port 8000]."""

import argparse

from bbocr_tpu_torch.server.app import create_app


def main(argv=None):
    p = argparse.ArgumentParser(description="bbocr_tpu_torch scanner service")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--data-dir", default=None)
    p.add_argument("--books-dir", default=None)
    p.add_argument("--device", default="cuda", help="where the jobs' preprocessing and OCR run")
    args = p.parse_args(argv)
    service = create_app(data_dir=args.data_dir, books_dir=args.books_dir, device=args.device)
    service.app.run(host=args.host, port=args.port)


if __name__ == "__main__":
    main()
