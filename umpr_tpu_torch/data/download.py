"""Threaded photo downloader for the photos.json manifest (port of
umpr_tpu/data/download.py).

    python -m umpr_tpu_torch.data.download --photos_json data/music/photos.json

Writes ``<dir of photos.json>/photos/<photo_id>.jpg``.  As the reference
(data/down_photos.py): a browser User-Agent, a 20 s socket timeout, up to
10 tries 0.5 s apart (down_photos.py:30-37), JPEG validity by the trailing
EOI marker \\xff\\xd9 (down_photos.py:21-27), and files that exist and
validate are skipped (down_photos.py:57).

The timeout and the opener are process-wide settings of ``socket`` and
``urllib``.  They are set when the downloader runs (``main``,
``download_photos``), never when this module is imported.
"""

from __future__ import annotations

import argparse
import os
import socket
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor, as_completed

import pandas as pd

SOCKET_TIMEOUT = 20  # seconds
USER_AGENT = ("Mozilla/5.0 (Windows NT 10.0; WOW64) AppleWebKit/537.36 "
              "(KHTML, like Gecko) Chrome/88.0.4324.182 Safari/537.36")


def install_opener():
    """The reference's process-wide settings: the socket timeout and an
    opener that sends USER_AGENT."""
    socket.setdefaulttimeout(SOCKET_TIMEOUT)
    opener = urllib.request.build_opener()
    opener.addheaders = [("User-agent", USER_AGENT)]
    urllib.request.install_opener(opener)


def is_valid_jpg(path):
    try:
        with open(path, "rb") as f:
            f.seek(-2, 2)
            return f.read() == b"\xff\xd9"
    except Exception:
        return False


def download_photo(url, path, retries=10):
    for _ in range(retries):
        try:
            urllib.request.urlretrieve(url, path)
            return True, None, None
        except Exception:
            time.sleep(0.5)
    return False, url, path


def download_photos(photos_json):
    install_opener()
    data_dir = os.path.dirname(photos_json)
    photo_dir = os.path.join(data_dir, "photos")
    os.makedirs(photo_dir, exist_ok=True)

    try:
        print(f"reading manifest: {photos_json}")
        df = pd.read_json(photos_json, orient="records", lines=True)
    except Exception:
        print('no photos.json found -- run the preprocessor first to generate it')
        return

    print(f"downloading photos into {photo_dir}")
    tasks = []
    with ThreadPoolExecutor() as pool:
        for name, url in zip(df["photo_id"], df["imUrl"]):
            path = os.path.join(photo_dir, name + ".jpg")
            if not os.path.exists(path) or not is_valid_jpg(path):
                tasks.append(pool.submit(download_photo, url, path))

        failed = []
        for i, task in enumerate(as_completed(tasks)):
            ok, url, path = task.result()
            if not ok:
                failed.append((url, path))
            print(f"progress: {i + 1}/{len(tasks)}", end="\r", flush=True)

    for url, path in failed:
        print(f"FAILED: {url} -> {path}")
    print(f"done: {len(tasks) - len(failed)} ok, {len(failed)} failed "
          f"({photo_dir})")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--photos_json", dest="photos_json", required=True)
    args = parser.parse_args(argv)
    download_photos(args.photos_json)


if __name__ == "__main__":
    main()
